"""Self-driving control plane: the verdict→action reflex arc.

:mod:`~smartbft_tpu_torch.obs.slo` holds the senses (declarative SLOs,
multi-window burn-rate verdicts), and the actuators are the breaker, the
occupancy autoscaler, live reshard, ordered-stream reconfig and the
RTT-derived timers; this package connects them.  Two layers, separable on purpose — the same
split :mod:`~smartbft_tpu_torch.shard.autoscale` uses:

* :mod:`~smartbft_tpu_torch.control.policy` — the pure DECISION core: health
  verdicts + live occupancy/RTT/drain EWMAs in, typed
  :class:`~smartbft_tpu_torch.control.policy.Remediation` out, with per-action
  hysteresis, cooldowns re-armed on failure, a global anti-thrash
  budget, and a breaker/transition veto.  Injectable clock, no I/O.
* :mod:`~smartbft_tpu_torch.control.loop` — the DRIVER: consumes one
  cluster's verdict stream and executes decisions through EXISTING seams
  only (``ShardSet.reshard`` for scale, ordered reconfig requests for
  derived-knob commits), so every automated action is itself an ordered,
  fork-free, exactly-once decision (the Vertical Paxos rule).
"""

from .loop import ControlLoop, run_control_loop
from .policy import (
    ControlPolicy,
    Remediation,
    TransitionArbiter,
    count_reversals,
    derive_knobs,
)

__all__ = [
    "ControlPolicy",
    "Remediation",
    "TransitionArbiter",
    "ControlLoop",
    "run_control_loop",
    "derive_knobs",
    "count_reversals",
]
