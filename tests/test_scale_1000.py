"""BASELINE config 3: 1000-accession bit-sliced database -- full
transpose + dense AND-reduce query on one device, host/device equality,
and mesh-sharded search equality (config 4's collective wiring)."""

import numpy as np
import pytest

from kwage.core import FilterInfo, str_to_accession
from kwage.core.params import BloomParam
from kwage.io.db_file import write_db_file, DBFileReader
from kwage.ops.search import DeviceSearcher
from kwage.pipeline.build_db import transpose_filters
from kwage.search.engine import search_database

N_FILTER = 1000
LOG2_L = 12


@pytest.fixture(scope="module")
def big_db(tmp_path_factory):
    """1000 random filters -> transpose -> .db on disk."""
    work = tmp_path_factory.mktemp("scale1000")
    rng = np.random.default_rng(1234)
    param = BloomParam(kmer_len=31, log_2_filter_len=LOG2_L, num_hash=3, hash_func=0)
    filters = rng.integers(0, 256, size=(N_FILTER, param.filter_len // 8), dtype=np.uint8)
    slices = transpose_filters(filters)
    infos = [FilterInfo(run_accession=str_to_accession(f"SRR{i+1}")) for i in range(N_FILTER)]
    path = work / "sra.big.db"
    write_db_file(str(path), param, slices, infos)
    return str(path), filters, param


def test_transpose_bit_exact_at_1000(big_db):
    path, filters, param = big_db
    reader = DBFileReader(path)
    assert reader.header.num_filter == N_FILTER
    assert reader.verify_crc32()
    slices = reader.read_slices()
    got = np.unpackbits(slices, axis=1, bitorder="little")[:, :N_FILTER]
    want = np.unpackbits(filters, axis=1, bitorder="little").T
    assert np.array_equal(got, want)


def test_device_search_matches_host_at_1000(big_db):
    path, filters, param = big_db
    rng = np.random.default_rng(7)
    queries = ["".join(rng.choice(list("ACGT"), size=120)) for _ in range(6)]

    searcher, reader = DeviceSearcher.from_file(path)
    for threshold in (1.0, 0.4):
        dev = searcher.search(queries, threshold)
        for qi, q in enumerate(queries):
            host = search_database(reader, q, threshold, slices=reader.read_slices())
            assert dev[qi] == host, f"query {qi} t={threshold}"


def test_sharded_search_matches_host_at_1000(big_db):
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    from kwage.parallel import ShardedDatabase, make_search_mesh
    from kwage.search.engine import query_threshold_count

    path, filters, param = big_db
    reader = DBFileReader(path)
    slices = reader.read_slices()

    mesh = make_search_mesh(2, len(jax.devices()) // 2)
    sdb = ShardedDatabase(mesh, param, slices, N_FILTER)

    rng = np.random.default_rng(8)
    queries = ["".join(rng.choice(list("ACGT"), size=90)) for _ in range(5)]

    counts, nk = sdb.search_counts(queries)
    mask, _ = sdb.search_complete(queries)
    for qi, q in enumerate(queries):
        host_all = search_database(reader, q, 0.0, slices=slices) or []
        host_counts = np.zeros(N_FILTER, np.int64)
        for fidx, num_match, _n in host_all:
            host_counts[fidx] = num_match
        assert np.array_equal(counts[qi], host_counts)
        host_complete = {f for f, nm, n in host_all if nm == n}
        assert set(np.nonzero(mask[qi])[0]) == host_complete
