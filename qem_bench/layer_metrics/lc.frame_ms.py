"""ops.lightcone frame pass: device time of the noise draws
(``sample_small_categorical``) and ``frame_signs`` a chunk (a
``run_noisy`` call), ms."""


def read(run):
    t = run.trace
    if not t or not t["kernels"] or not t["count"].get("run_noisy"):
        return None
    dev = t["device_s"]
    return (dev.get("sample_small_categorical", 0.0)
            + dev.get("frame_signs", 0.0)) / t["count"]["run_noisy"] * 1e3
