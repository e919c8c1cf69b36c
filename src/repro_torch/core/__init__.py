"""MPWide core of the port: paths, streamed and ring collectives, the
autotuner, telemetry, relays, the multi-site topology and Forwarder, the
chaos layer, elastic membership and local SGD, file transfer (mpw-cp),
serving, and the MPW_* API."""
from repro_torch.core.api import MPW  # noqa: F401
from repro_torch.core.autotune import (  # noqa: F401
    OnlineTuner,
    RouteTuner,
    Tuning,
    autotune_path,
    simulate_transfer_s,
    tune,
)
from repro_torch.core.chaos import (  # noqa: F401
    ChaosDetector,
    ChaosMonitor,
    IncidentLog,
    get_incident_log,
    healing_transfer,
    link_fault_hook,
)
from repro_torch.core.buckets import (  # noqa: F401
    Bucket,
    BucketPlan,
    bucketed_sync,
    plan_buckets,
)
from repro_torch.core.collectives import (  # noqa: F401
    flat_allreduce,
    gateway_allreduce,
    hierarchical_allreduce,
    local_site_allreduce,
    site_allreduce,
    streamed_psum,
    wide_allreduce,
)
from repro_torch.core.cycle import (  # noqa: F401
    barrier,
    cycle,
    forward,
    pod_shift,
    relay,
    sendrecv,
)
from repro_torch.core.filetransfer import (  # noqa: F401
    FileJob,
    FileResult,
    FileTransfer,
    file_sha256,
    local_transfer,
    plan_file_chunks,
)
from repro_torch.core.kvship import (  # noqa: F401
    KVShipPlan,
    KVShipResult,
    kv_cache_bytes,
    plan_kv_ship,
    ship_kv,
)
from repro_torch.core.localsgd import LocalSGDController  # noqa: F401
from repro_torch.core.membership import QuorumPolicy, SiteMembership  # noqa: F401
from repro_torch.core.overlap import accum_grads  # noqa: F401
from repro_torch.core.path import (  # noqa: F401
    ICI,
    INTERPOD,
    Hop,
    LinkSpec,
    WidePath,
    local_path,
)
from repro_torch.core.retry import PROBE_RETRY, RetryPolicy, RetryState  # noqa: F401
from repro_torch.core.serving import (  # noqa: F401
    ContinuousBatcher,
    FixedBatchScheduler,
    Request,
    modeled_ship_steps,
)
from repro_torch.core.ring import (  # noqa: F401
    ring_all_gather,
    ring_allreduce,
    ring_reduce_scatter,
    wire_bytes_per_pod,
)
from repro_torch.core.telemetry import PathTelemetry, Telemetry, get_telemetry  # noqa: F401
from repro_torch.core.topology import (  # noqa: F401
    LAN,
    Fault,
    Forwarder,
    LinkHealth,
    LinkProfile,
    Route,
    Site,
    Topology,
    cosmogrid_topology,
)
