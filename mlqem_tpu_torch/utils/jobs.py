"""Job management: persistence, failure detection, resubmission.

Counterpart of ``mlqem_tpu/utils/jobs.py``, host only; the JSON ledger has
the JAX package's schema, so either package reads the other's. Rebuilds
the reference's hardware-campaign plumbing (SURVEY §5 — job ids persisted
per (step, J) to json, '# Resubmission' loops re-querying and
re-submitting failed jobs, ``h31``/``h35`` notebooks) as a reusable
subsystem. Works with any Estimator-primitive backend; simulated backends
complete synchronously, and the same ledger/retry path would drive a remote
backend adapter.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class JobRecord:
    key: str
    job_id: Optional[str] = None
    status: str = "PENDING"      # PENDING | DONE | FAILED
    values: Optional[list] = None
    error: Optional[str] = None
    attempts: int = 0
    submitted_at: Optional[float] = None


class JobLedger:
    """Persistent (JSON) record of submitted jobs keyed by experiment tag.

    Mirrors the reference's per-(step, J) job-id json files with
    re-query/resubmit support.
    """

    def __init__(self, path: str):
        self.path = path
        self.records: Dict[str, JobRecord] = {}
        if os.path.exists(path):
            with open(path) as f:
                raw = json.load(f)
            self.records = {k: JobRecord(**v) for k, v in raw.items()}

    def save(self):
        with open(self.path, "w") as f:
            json.dump({k: dataclasses.asdict(v)
                       for k, v in self.records.items()}, f, indent=1)

    def pending_or_failed(self) -> List[str]:
        return [k for k, r in self.records.items()
                if r.status in ("PENDING", "FAILED")]

    def record(self, key: str) -> JobRecord:
        if key not in self.records:
            self.records[key] = JobRecord(key=key)
        return self.records[key]


def run_with_resubmission(ledger: JobLedger,
                          submit: Callable[[str], Any],
                          keys: List[str],
                          max_attempts: int = 3,
                          save_every: int = 1) -> Dict[str, JobRecord]:
    """Submit per-key jobs with failure detection + bounded resubmission.

    ``submit(key)`` returns a Job of the port's Estimators
    (``.job_id()``, ``.result().values``). Completed keys are
    skipped on re-entry (resume-from-ledger), failures are retried up to
    ``max_attempts`` — the reference's notebook resubmission loop as a
    function.
    """
    done = 0
    for key in keys:
        rec = ledger.record(key)
        if rec.status == "DONE":
            continue
        while rec.attempts < max_attempts and rec.status != "DONE":
            rec.attempts += 1
            rec.submitted_at = time.time()
            try:
                job = submit(key)
                rec.job_id = job.job_id()
                result = job.result()
                rec.values = [float(v) for v in result.values]
                rec.status = "DONE"
                rec.error = None
            except Exception as exc:  # failure detection
                rec.status = "FAILED"
                rec.error = f"{type(exc).__name__}: {exc}"
        done += 1
        if done % save_every == 0:
            ledger.save()
    ledger.save()
    return ledger.records
