"""Core runtime of the PyTorch port: types, logging, graphs, devices.

Reference: GenomeWorks ``common/base`` (lib gwbase).
"""

from genomeworks_tpu_torch.core.types import (
    read_id_t,
    position_in_read_t,
    representation_t,
)
from genomeworks_tpu_torch.core.sequence import (
    encode_bases,
    decode_bases,
    reverse_complement,
    BASE_TO_CODE,
    CODE_TO_BASE,
)
from genomeworks_tpu_torch.core.bucketing import (
    pad_to_multiple,
    bucket_by_length,
    Bucket,
)
from genomeworks_tpu_torch.core.logging import (
    LogLevel,
    initialize_logger,
    log_critical,
    log_error,
    log_warn,
    log_info,
    log_debug,
)
from genomeworks_tpu_torch.core.graph import Graph, DirectedGraph, UndirectedGraph
from genomeworks_tpu_torch.core.device import (
    DeviceInfo,
    DeviceRuntimeError,
    get_device_count,
    get_devices,
    get_device_memory_info,
    resolve_device,
)
