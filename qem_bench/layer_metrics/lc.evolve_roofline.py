"""ops.kernels (K3's wide tier): the least time of the window evolutions'
work, ``kicked_steps`` with its per-step ⟨Z_obs⟩
(``yardstick.window_evolve_work`` against the published peaks) ÷ the
device time of ``evolve_stepwise``, %."""
from qem_bench.yardstick import bound


def read(run):
    t = run.trace
    work = t and t["work"].get("evolve_stepwise")
    if not work or not t["kernels"] or \
            not t["device_s"].get("evolve_stepwise"):
        return None
    least = sum(bound(b, f) for b, f in work)
    return 100.0 * least / t["device_s"]["evolve_stepwise"]
