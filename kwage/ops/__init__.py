from .kmers import canonical_kmers_device, encode_bases_device
from .hashing import murmur32_device, slice_indices_device
from .transpose import transpose_bits_device, transpose_chunks_device
from .counting import (
    build_filter_device,
    count_kmers_device,
    set_filter_bits,
)
from .search import (
    DeviceSearcher,
    db_bytes_to_words,
    make_query_batch,
    search_complete,
    search_counts,
    search_files_device,
)
