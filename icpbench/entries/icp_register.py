"""One pair a call: the program's ``icp_register``."""


def make_call(program, pool, cfg, device, fields):
    """fn([j]) -> ``fields`` of pool pair j's result, each with a leading
    pair axis of 1."""
    def call(pairs):
        (j,) = pairs
        r = program.icp_register(pool.fixed[j], pool.movable[j], cfg, device=device)
        return {k: getattr(r, k)[None] for k in fields}
    return call
