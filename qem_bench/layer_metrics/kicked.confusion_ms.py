"""ops.kicked_ising stage (d)'s readout alone: the marginal readout
inside ``trajectory_z`` (one reduction of the distribution to each
qubit's ⟨Z⟩ and the row's total, then the confusion's affine map): device
time of the program's ``kicked.confusion`` spans a ``kicked.generate``
request, ms."""
from qem_bench.program_spans import per_span_ms


def read(run):
    return per_span_ms("device_s",
                       "kicked.generate/kicked.readout/kicked.confusion",
                       "kicked.generate")
