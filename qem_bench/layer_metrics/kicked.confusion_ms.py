"""ops.kicked_ising stage (d)'s readout confusion alone
(``apply_readout_confusion`` inside ``trajectory_z``): device time of the
program's ``kicked.confusion`` spans a ``kicked.generate`` request, ms."""
from qem_bench.program_spans import per_span_ms


def read(run):
    return per_span_ms("device_s",
                       "kicked.generate/kicked.readout/kicked.confusion",
                       "kicked.generate")
