"""repro_torch.kvcache: Iris-planned packed KV-cache streams (port of
``src/repro/kvcache``).  The attention kernel's wrapper lives in
:mod:`repro_torch.kvcache.stream_attention` (not re-exported, so the
module name stays the module)."""
from .cache import KVManifest, PackedKVCache, dequantize_kv, quantize_kv
from .layout import (
    append_tables,
    full_stream_tables,
    kv_bundle,
    page_stream_tables,
    plan_kv_stack,
)

__all__ = [
    "KVManifest",
    "PackedKVCache",
    "append_tables",
    "dequantize_kv",
    "full_stream_tables",
    "kv_bundle",
    "page_stream_tables",
    "plan_kv_stack",
    "quantize_kv",
]
