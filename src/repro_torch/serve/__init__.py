"""Continuous-batching serve subsystem of the PyTorch port: per-arch
request queues routed onto the (trial k, microbatch m, batch-row b) slot
grid of one co-serving gang. The host-side modules are copies of
``repro.serve``'s; the engine is the split-admission port over the paged
pool or dense per-slot strips."""
from repro_torch.serve.request import (  # noqa: F401
    Completion,
    Request,
    load_trace,
    poisson_trace,
    save_trace,
)
from repro_torch.serve.batcher import (  # noqa: F401
    POLICIES,
    Batcher,
    ResumeState,
    Slot,
)
from repro_torch.serve.engine import ServeEngine, ServeStats  # noqa: F401
from repro_torch.serve.paging import (  # noqa: F401
    BlockAllocator,
    BlockTable,
    blocks_for,
)
from repro_torch.serve.store import BlockStore, HostBlock  # noqa: F401
from repro_torch.serve.transfer import TransferEngine, make_null_transfer  # noqa: F401
