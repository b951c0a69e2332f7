"""Device milliseconds of the halo exchange per sharded application,
summed over the mesh: the slice's peer copies between cards (``Memcpy
PtoP``, which ``parallel/stream_shard.HaloExchange`` issues, ``2 x (cards -
1)`` an application) over its applications (``2 x pairs`` a request). None
where the slice holds no peer copy, as on one card."""

# the name the trace gives a copy from one card to another
PEER = "PtoP"


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.requests == 0:
        return None
    copies = [b - a for a, b, name in sl.copies() if PEER in name]
    if not copies:
        return None
    applications = (sl.requests * ctx.work.computed_timesteps
                    // ctx.work.step)
    return sum(copies) / 1e3 / applications
