"""A group of consecutive pool pairs a call: the program's
``icp_register_batch``."""


def make_call(program, pool, cfg, device, fields):
    """fn(pairs) -> ``fields`` of the group's result, one row a pair."""
    def call(pairs):
        lo, hi = pairs[0], pairs[-1] + 1
        r = program.icp_register_batch(pool.fixed[lo:hi], pool.movable[lo:hi], cfg,
                                       device=device)
        return {k: getattr(r, k) for k in fields}
    return call
