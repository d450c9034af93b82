"""ops.kicked_ising stage (d): readout confusion and ⟨Z⟩
(``trajectory_z``) and the shots (``shot_labels``), device time a call,
ms."""


def read(run):
    t = run.trace
    if not t or not t["kernels"] or not t["count"].get("call"):
        return None
    dev = t["device_s"]
    return (dev.get("trajectory_z", 0.0) + dev.get("shot_labels", 0.0)) \
        / t["count"]["call"] * 1e3
