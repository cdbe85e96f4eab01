"""Data layer (twin of ``genomics_lm_tpu/data``): lossless packing, packed
datasets with the epoch plan and the device prefetcher, dataset manifests
and vocabulary contracts. Numpy copies of the JAX modules, apart from
``DevicePrefetcher``; the on-disk formats are the JAX package's."""

from genomics_lm_torch.data.packing import (  # noqa: F401
    PACKING_METADATA_FIELDS,
    PackedSpan,
    PackedWindow,
    TokenChunk,
    chunk_record,
    pack_chunks,
    packed_arrays,
    packing_metadata_rows,
)
