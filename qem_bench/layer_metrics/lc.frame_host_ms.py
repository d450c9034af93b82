"""ops.lightcone frame pass: host time of the noise draws
(``sample_small_categorical``) and ``frame_signs`` a chunk (a
``run_noisy`` call), ms, profiler on: the launches of its many small
operations, during which the device idles."""


def read(run):
    t = run.trace
    if not t or not t["count"].get("run_noisy") \
            or "frame_signs" not in t["host_s"]:
        return None
    host = t["host_s"]
    return (host.get("sample_small_categorical", 0.0) + host["frame_signs"]) \
        / t["count"]["run_noisy"] * 1e3
