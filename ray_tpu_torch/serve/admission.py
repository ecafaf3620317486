"""SLO-aware admission control for the serve ingress (copied from
ray_tpu/serve/admission.py).

The HTTP proxy gates a request before ``anatomy.admit``: when the
predicted TTFT blows the deployment's declared ``slo_ttft_ms``, new
arrivals degrade to a bounded queue, and once the queue budget is spent
(or the queued wait expires) they are shed with HTTP 503 + Retry-After.
Because the gate runs before admit, a shed request never creates a phase
ledger: it cannot count as an SLO breach, so the scoreboard's goodput
reflects only the work the replicas accepted.

Decision table (``decide``):

    predicted vs SLO x headroom | queued vs budget | action
    ----------------------------+------------------+---------------------
    no SLO / no prediction      |        -         | admit
    predicted <= slo x headroom |        -         | admit
    predicted  > slo x headroom | queued <  budget | queue (bounded wait)
    predicted  > slo x headroom | queued >= budget | shed  (queue_full)
    budget == 0                 |        -         | shed  (predicted_ttft)

Env knobs (read once at config construction):
- ``RAY_TPU_SERVE_QUEUE_BUDGET``   max queued-at-the-gate requests per
  deployment before shedding (default 32; 0 = shed immediately on breach)
- ``RAY_TPU_SERVE_QUEUE_WAIT_S``   max seconds a queued request waits for
  predicted TTFT to clear before shedding (default 2.0)
- ``RAY_TPU_SERVE_ADMIT_HEADROOM`` multiplier on the SLO before the gate
  engages (default 1.0; >1 tolerates brief excursions)

Shed accounting: ``anatomy.record_shed`` increments
``ray_tpu_serve_shed_total{deployment,reason}`` (and the requests_total
outcome="shed" series) and records a rate-limited "shed" event on the
"serve" flight ring.

``anatomy_predictor`` is the predictor the port's HTTP proxy is given:
anatomy's worst-replica predicted TTFT and the deployment's declared SLO.
The reference's replicated front door feeds the gate from its routing
epochs instead (ROADMAP queue 1 item 3.6).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

ADMIT = "admit"
QUEUE = "queue"
SHED = "shed"

# shed reason vocabulary (the {reason} tag on ray_tpu_serve_shed_total)
REASON_PREDICTED_TTFT = "predicted_ttft"  # breach with no queue budget
REASON_QUEUE_FULL = "queue_full"          # queue budget exhausted
REASON_QUEUE_TIMEOUT = "queue_timeout"    # queued wait expired unserved

_WAIT_SLICE_S = 0.5  # a queued request re-reads its predictor at least this often


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


@dataclass
class AdmissionConfig:
    queue_budget: int = field(
        default_factory=lambda: _env_int("RAY_TPU_SERVE_QUEUE_BUDGET", 32))
    queue_wait_s: float = field(
        default_factory=lambda: _env_float("RAY_TPU_SERVE_QUEUE_WAIT_S", 2.0))
    headroom: float = field(
        default_factory=lambda: _env_float("RAY_TPU_SERVE_ADMIT_HEADROOM",
                                           1.0))
    poll_s: float = 0.05  # queued re-evaluation cadence


def decide(predicted_ttft_ms, slo_ttft_ms, queued: int,
           cfg: AdmissionConfig) -> tuple:
    """Pure decision: (action, shed_reason|None). No clocks, no state —
    the whole policy is this table (tested as one)."""
    if slo_ttft_ms is None or predicted_ttft_ms is None:
        return ADMIT, None
    if predicted_ttft_ms <= float(slo_ttft_ms) * cfg.headroom:
        return ADMIT, None
    if cfg.queue_budget <= 0:
        return SHED, REASON_PREDICTED_TTFT
    if queued >= cfg.queue_budget:
        return SHED, REASON_QUEUE_FULL
    return QUEUE, None


class AdmissionGate:
    """Per-ingress gate: evaluates ``decide`` against a predictor and owns
    the degrade-to-queue wait (condition-variable; queued requests re-check
    as slots free and time passes, never unbounded).

    ``predictor(deployment) -> (predicted_ttft_ms | None, slo_ttft_ms | None)``
    must be cheap and RPC-free (``anatomy_predictor`` is one).
    """

    def __init__(self, predictor, cfg: AdmissionConfig | None = None):
        self._predictor = predictor
        self.cfg = cfg or AdmissionConfig()
        self._cond = threading.Condition()
        self._queued: dict[str, int] = {}  # deployment -> gate-queued count
        self._shed_counts: dict[tuple, int] = {}  # (dep, reason) -> count

    def queued(self, deployment: str) -> int:
        with self._cond:
            return self._queued.get(deployment, 0)

    def shed_counts(self) -> dict:
        with self._cond:
            return {f"{d}:{r}": n for (d, r), n in self._shed_counts.items()}

    def _shed(self, deployment: str, reason: str) -> tuple:
        with self._cond:
            key = (deployment, reason)
            self._shed_counts[key] = self._shed_counts.get(key, 0) + 1
        from ray_tpu_torch.serve import anatomy

        anatomy.record_shed(deployment, reason)
        return False, reason

    def try_admit(self, deployment: str) -> tuple:
        """(admitted, shed_reason|None). Blocks at most ``queue_wait_s``
        while degraded to the gate queue."""
        pred, slo = self._predictor(deployment)
        action, reason = decide(pred, slo, self.queued(deployment), self.cfg)
        if action == ADMIT:
            return True, None
        if action == SHED:
            return self._shed(deployment, reason)
        # degrade-to-queue: hold a budget slot, re-evaluate until the
        # prediction clears or the wait expires
        deadline = time.monotonic() + self.cfg.queue_wait_s
        with self._cond:
            self._queued[deployment] = self._queued.get(deployment, 0) + 1
        try:
            while True:
                pred, slo = self._predictor(deployment)
                if (slo is None or pred is None
                        or pred <= float(slo) * self.cfg.headroom):
                    return True, None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._shed(deployment, REASON_QUEUE_TIMEOUT)
                with self._cond:
                    self._cond.wait(min(self.cfg.poll_s, remaining, _WAIT_SLICE_S))
        finally:
            with self._cond:
                n = self._queued.get(deployment, 1) - 1
                if n <= 0:
                    self._queued.pop(deployment, None)
                else:
                    self._queued[deployment] = n
                self._cond.notify_all()  # a budget slot freed


def anatomy_predictor(deployment: str) -> tuple:
    """(predicted TTFT ms | None, slo_ttft_ms | None) from this process's
    request anatomy: the deployment's worst replica's in-flight depth times
    its recent service time, and the SLO its deployment declared."""
    from ray_tpu_torch.serve import anatomy

    return (anatomy.predicted_ttft_by_deployment().get(deployment),
            anatomy.slo_ttft_ms(deployment))
