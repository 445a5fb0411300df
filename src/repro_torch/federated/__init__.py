"""The federated runtime of the port: the simulator's runners, the policy
servers and their policies, the cohort engine, the scheduler and the
latency models (the reference's ``repro.federated`` names; see
``tests/test_torch_surface.py`` for the names it leaves out, and why)."""
from repro_torch.federated.simulator import (
    ALGORITHMS,
    ENGINES,
    SimConfig,
    SimResult,
    SweepConfig,
    SweepResult,
    make_sketch_fn,
    make_sketch_fn_flat,
    make_sketch_fn_lanes,
    run_algorithm,
    run_async,
    run_fedavg,
    run_sweep,
)
from repro_torch.federated.cohort import CohortEngine, StreamingCohortEngine
from repro_torch.federated.timeline import Timeline
from repro_torch.federated.servers import (LanePolicyServer, PolicyServer,
                                           ShardedPolicyServer, make_lane_server,
                                           make_server, server_state_specs)
from repro_torch.federated.policies import (
    POLICY_NAMES,
    Arrival,
    Policy,
    PolicyParams,
    ServerState,
    make_hyper,
    make_policy,
)
from repro_torch.federated.scheduler import (SCHEDULERS, Dispatcher,
                                             PeriodTriggeredScheduler,
                                             Scheduler,
                                             StalenessAwareScheduler,
                                             UniformRefillScheduler,
                                             make_scheduler, make_streams)
from repro_torch.federated.client import local_update
from repro_torch.federated.legacy import make_legacy_server
from repro_torch.federated.latency import (AvailabilityTrace,
                                           make_availability_trace,
                                           make_latency_sampler,
                                           per_client_availability,
                                           per_client_latency)
