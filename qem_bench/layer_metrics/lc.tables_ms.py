"""ops.lightcone host: ``window_tables`` a window (host time), ms."""


def read(run):
    t = run.trace
    if not t or not t["count"].get("window_tables"):
        return None
    return t["host_s"]["window_tables"] / t["count"]["window_tables"] * 1e3
