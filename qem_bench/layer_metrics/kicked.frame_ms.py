"""ops.kicked_ising stage (b), the frame pass: device time of
``sample_draws`` and ``frame_signs`` a call, ms."""


def read(run):
    t = run.trace
    if not t or not t["kernels"] or not t["count"].get("call"):
        return None
    dev = t["device_s"]
    return (dev.get("sample_draws", 0.0) + dev.get("frame_signs", 0.0)) \
        / t["count"]["call"] * 1e3
