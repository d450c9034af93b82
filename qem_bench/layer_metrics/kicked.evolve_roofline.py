"""ops.kernels (K1): the least time of the kicked engine's ``evolve``
stage's work (``yardstick.kicked_evolve_work`` against the published
peaks) ÷ its device time, %."""
from qem_bench.yardstick import bound


def read(run):
    t = run.trace
    work = t and t["work"].get("evolve")
    if not work or not t["kernels"] or not t["device_s"].get("evolve"):
        return None
    least = sum(bound(b, f) for b, f in work)
    return 100.0 * least / t["device_s"]["evolve"]
