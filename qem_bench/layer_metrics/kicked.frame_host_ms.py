"""ops.kicked_ising stage (b), the frame pass: host time of
``sample_draws`` and ``frame_signs`` a call (the launches of its many small
operations; the device idles meanwhile), ms, profiler on."""


def read(run):
    t = run.trace
    if not t or not t["count"].get("call") or "frame_signs" not in t["host_s"]:
        return None
    host = t["host_s"]
    return (host.get("sample_draws", 0.0) + host["frame_signs"]) \
        / t["count"]["call"] * 1e3
