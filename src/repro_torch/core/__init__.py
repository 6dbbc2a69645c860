"""Core: the calibrated ZNS device model (zone state machine + latency
model + event engine), its chain-program solver, and the
conventional-SSD GC baseline it is compared against, ported to PyTorch.
Lowering runs on the host in numpy; solves run on the selected device
(``device=``, CUDA by default)."""
from .spec import (  # noqa: F401
    KiB, MiB, GiB,
    ConvDeviceSpec, LBAFormat, OpType, Stack, ZNSDeviceSpec, ZoneState,
    SN640, ZN540, conv_spec_from_dict, spec_from_dict,
)
from .state_machine import ZoneError, ZoneManager, transition_array  # noqa: F401
from .latency import (  # noqa: F401
    DEFAULT_LATENCY_MODEL, DEFAULT_LATENCY_PARAMS, LatencyModel,
    LatencyParams, latency_params_from_arrays, resolve_params,
    stack_latency_params, unstack_latency_params, zn540_params,
)
from .torch_device import resolve_device  # noqa: F401
from .engine import (  # noqa: F401
    SimResult, SteadyStateResult, ThroughputModel, Trace,
    compute_service_times, simulate, simulate_vectorized,
    zone_sequential_completions, zone_sequential_completions_batched,
)
from .chain_program import (  # noqa: F401
    ChainProgram, CompileStats, SolveStats, block_adjacency, build_program,
    clear_program_cache, compile_fleet_program, compile_program,
    concat_programs, extend_program, force_layout, last_compile_stats,
    last_solve_stats, program_cache_dir, program_cache_info,
    program_chains, set_program_cache_dir, solve_program,
    unjustified_slots, verify_fixpoint,
)
from .conventional import ConventionalSSD, zns_write_pressure_series  # noqa: F401
from .metrics import (  # noqa: F401
    LatencyStats, available_metrics, bandwidth_bytes, extract_metrics, iops,
    register_metric, slo_violations, throughput_timeseries,
    unregister_metric, violation_rate,
)
from .arrival import (  # noqa: F401
    ArrivalProcess, DeterministicRate, MarkovModulated, PoissonArrivals,
    TraceReplay, spread_into_windows,
)
from .workload import StreamSpec, WorkloadSpec  # noqa: F401
from .fleet import batched_sequential_completions, simulate_fleet_vectorized  # noqa: F401
from .device import (  # noqa: F401
    ConvDevice, DeviceFleet, FleetRunResult, PressureResult, RunResult,
    ZnsDevice, available_backends, available_pressure_backends,
    register_backend, register_pressure_backend, unregister_backend,
)
from . import calibration, emulator_models, workloads  # noqa: F401
