from repro_torch.ft.elastic import RemeshPlan, apply_remesh, plan_remesh  # noqa: F401
from repro_torch.ft.heartbeat import HeartbeatMonitor  # noqa: F401
from repro_torch.ft.straggler import StragglerPolicy, StepTimeMonitor  # noqa: F401
