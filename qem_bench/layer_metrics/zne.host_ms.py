"""workflows.zne_scale: the time of a call outside
``KickedIsingEngine.generate`` (engine construction, the host
extrapolation), ms, from the spans' host time."""


def read(run):
    t = run.trace
    if not t or not t["count"].get("call") or "generate" not in t["host_s"]:
        return None
    return (t["host_s"]["call"] - t["host_s"]["generate"]) \
        / t["count"]["call"] * 1e3
