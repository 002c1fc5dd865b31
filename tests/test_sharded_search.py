"""Multi-device sharded search == single-device search (8-way CPU mesh)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kwage.core.params import BloomParam
from kwage.ops.search import (
    db_bytes_to_words,
    make_query_batch,
    search_complete,
    search_counts,
    unpack_mask,
)
from kwage.parallel import ShardedDatabase, make_search_mesh
from kwage.pipeline.build_db import transpose_filters

rng = np.random.default_rng(21)


def rand_seq(n):
    return "".join(rng.choice(list("ACGT")) for _ in range(n))


@pytest.fixture(scope="module")
def corpus():
    num_filter, L = 512, 4096  # 16 packed words -> 2 words per filter shard
    filters = rng.integers(0, 256, size=(num_filter, L // 8), dtype=np.uint8)
    slices = transpose_filters(filters)
    param = BloomParam(kmer_len=31, log_2_filter_len=12, num_hash=3, hash_func=0)
    return param, slices, num_filter


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (8, 1)])
def test_sharded_matches_single_device(corpus, mesh_shape):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    param, slices, num_filter = corpus
    mesh = make_search_mesh(*mesh_shape)
    sdb = ShardedDatabase(mesh, param, slices, num_filter)

    queries = [rand_seq(100), rand_seq(200), rand_seq(64)]

    # Reference: single-device kernels.
    db = jnp.asarray(db_bytes_to_words(slices))
    idx, valid, nk = make_query_batch(
        queries, param.kmer_len, param.num_hash, param.log_2_filter_len
    )
    want_counts = np.asarray(search_counts(db, jnp.asarray(idx), jnp.asarray(valid)))[:, :num_filter]
    want_mask = unpack_mask(
        np.asarray(search_complete(db, jnp.asarray(idx), jnp.asarray(valid))), num_filter
    )

    got_counts, _ = sdb.search_counts(queries)
    got_mask, _ = sdb.search_complete(queries)
    np.testing.assert_array_equal(got_counts, want_counts)
    np.testing.assert_array_equal(got_mask, want_mask)


def test_global_mesh_and_inventory_sharding():
    import jax

    from kwage.parallel import make_global_search_mesh, shard_inventory

    if len(jax.devices()) < 2:
        import pytest

        pytest.skip("needs a multi-device mesh")
    mesh = make_global_search_mesh()
    assert set(mesh.axis_names) == {"data", "filters"}
    assert mesh.devices.size == len(jax.devices())

    # Equal chunks, remainder to the last host (sra_stream.cpp:525-543).
    spans = [shard_inventory(10, r, 3) for r in range(3)]
    assert spans == [(0, 3), (3, 6), (6, 10)]


def test_total_hits_psum_matches_counts():
    """The psum-reduced corpus totals equal the brute count from the full
    sharded hit matrix."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    from kwage.core.params import BloomParam
    from kwage.parallel import ShardedDatabase, make_search_mesh
    from kwage.search.engine import query_threshold_count

    rng = np.random.default_rng(12)
    L, F = 1 << 12, 32 * len(jax.devices())
    filters_arr = rng.integers(0, 256, size=(F, L // 8), dtype=np.uint8)
    slices = transpose_filters(filters_arr)
    param = BloomParam(kmer_len=31, log_2_filter_len=12, num_hash=3, hash_func=0)
    mesh = make_search_mesh(2 if len(jax.devices()) >= 4 else 1,
                            len(jax.devices()) // (2 if len(jax.devices()) >= 4 else 1))
    sdb = ShardedDatabase(mesh, param, slices, F)

    queries = ["".join(rng.choice(list("ACGT"), size=70)) for _ in range(3)]
    threshold = 0.3
    totals = sdb.total_hits(queries, threshold)
    counts, nk = sdb.search_counts(queries)
    for qi in range(len(queries)):
        qt = max(query_threshold_count(threshold, int(nk[qi])), 1)
        assert totals[qi] == int((counts[qi] >= qt).sum()), qi


@pytest.mark.parametrize("mesh_shape,budget", [((8, 1), 16384), ((1, 8), 4096), ((2, 4), 8192)])
def test_hbm_budget_waves_match_unbudgeted(corpus, mesh_shape, budget):
    """A per-shard HBM budget far smaller than the corpus forces multi-wave
    streaming; counts, complete masks, and psum totals must be identical
    to the fully-resident path (the mesh analog of the reference's 1 GiB
    transpose-buffer discipline, build_db.cpp:236-248)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    param, slices, num_filter = corpus
    mesh = make_search_mesh(*mesh_shape)
    resident = ShardedDatabase(mesh, param, slices, num_filter)
    waved = ShardedDatabase(mesh, param, slices, num_filter, budget_bytes=budget)
    assert waved.num_waves > 1, "budget did not force multiple waves"
    assert waved.db is None  # nothing stays resident

    queries = [rand_seq(100), rand_seq(200), rand_seq(64)]
    want_counts, _ = resident.search_counts(queries)
    got_counts, _ = waved.search_counts(queries)
    np.testing.assert_array_equal(got_counts, want_counts)

    want_mask, _ = resident.search_complete(queries)
    got_mask, _ = waved.search_complete(queries)
    np.testing.assert_array_equal(got_mask, want_mask)

    np.testing.assert_array_equal(
        waved.total_hits(queries, 0.3), resident.total_hits(queries, 0.3)
    )


def test_budget_shared_across_groups(tmp_path):
    """Resident groups claim from ONE budget pool; streaming groups size
    waves within the remainder. (Per-group budgets over-committed HBM at
    production L: a resident merged-file group sat alongside a streaming
    full-file group whose waves used the whole budget.)"""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.db_file import write_db_file
    from kwage.parallel.sharded_search import (
        build_sharded_groups,
        search_sharded_groups,
    )
    from kwage.search.engine import search_database_files

    param = BloomParam(kmer_len=31, log_2_filter_len=12, num_hash=3, hash_func=0)
    lrng = np.random.default_rng(5)

    def mk(path, nf, acc0):
        slices = lrng.integers(
            0, 256, size=(1 << 12, (nf + 7) // 8), dtype=np.uint8)
        infos = [FilterInfo(run_accession=str_to_accession(f"SRR4{acc0 + i:06d}"))
                 for i in range(nf)]
        write_db_file(str(path), param, slices, infos)
        return str(path)

    small = mk(tmp_path / "small.db", 64, 0)      # 2 packed words wide
    big = mk(tmp_path / "big.db", 4096, 1000)     # 128 words wide
    files = [small, big]
    n_shards = 8
    mesh = make_search_mesh(1, n_shards)
    budget = 68 << 10  # small (4 KiB/dev) goes resident; big must stream
    groups = build_sharded_groups(mesh, files, budget_bytes=budget)
    assert len(groups) == 2
    (sdb_small, _), (sdb_big, _) = groups
    assert sdb_small.num_waves == 1 and sdb_small.db is not None
    assert sdb_big.num_waves > 1 and sdb_big.db is None
    # Big group's waves fit the pool the resident group leaves free:
    # per-device peak = resident + 2 waves <= budget.
    small_dev = sdb_small._waves[0][0].nbytes // n_shards
    wave_dev = max(w.nbytes // n_shards for w, _ in sdb_big._waves)
    assert small_dev + 2 * wave_dev <= budget

    queries = [(i, rand_seq(n)) for i, n in enumerate((100, 64, 150))]
    for threshold in (1.0, 0.4):
        got = search_sharded_groups(groups, files, queries, threshold)
        want = search_database_files(files, queries, threshold)
        assert set(got) == set(want)
        for qid in want:
            assert [
                (m.num_kmers_found, m.num_query_kmer,
                 int(m.subject_info.run_accession)) for m in got[qid]
            ] == [
                (m.num_kmers_found, m.num_query_kmer,
                 int(m.subject_info.run_accession)) for m in want[qid]
            ]


def test_resident_sharded_groups_reusable(tmp_path, data_dir, golden_dir):
    """build_sharded_groups once, search many times (the mesh serving
    primitive): results identical to the one-shot sharded_search_files."""
    import json

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.inventory import write_inventory
    from kwage.io.sequence import iter_sequences
    from kwage.parallel.maestro import LocalFastaResolver, Maestro, MaestroOptions
    from kwage.parallel.sharded_search import (
        build_sharded_groups,
        search_sharded_groups,
        sharded_search_files,
    )

    with open(golden_dir / "e2e" / "manifest.json") as f:
        man = json.load(f)
    write_inventory(str(tmp_path / "inv.bin"),
                    [FilterInfo(run_accession=str_to_accession(a))
                     for a in man["accessions"][:5]])
    opt = MaestroOptions(
        metadata_file=str(tmp_path / "inv.bin"),
        scratch_bloom_dir=str(tmp_path / "bloom"),
        scratch_database_dir=str(tmp_path / "db"),
        status_file=str(tmp_path / "status.bin"),
        kmer_len=man["k"], min_kmer_count=man["min_kmer_count"],
        false_positive_probability=man["fp"],
        min_log_2_filter_len=man["minL"], max_log_2_filter_len=man["maxL"],
        min_log_2_count_len=man["minLc"], max_log_2_count_len=man["maxLc"],
    )
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()
    import os

    files = sorted(
        os.path.join(tmp_path, "db", f)
        for f in os.listdir(tmp_path / "db") if f.endswith(".db")
    )
    queries = [(i, s) for i, (_, s) in
               enumerate(iter_sequences(str(data_dir / "queries.fasta")))][:3]
    mesh = make_search_mesh(2, 4)
    groups = build_sharded_groups(mesh, files, budget_bytes=1 << 10)
    for threshold in (1.0, 0.5):
        got = search_sharded_groups(groups, files, queries, threshold)
        want = sharded_search_files(mesh, files, queries, threshold,
                                    budget_bytes=1 << 10)
        assert set(got) == set(want)
        for qid in want:
            g = [(r.num_kmers_found, r.num_query_kmer,
                  int(r.subject_info.run_accession)) for r in got[qid]]
            w = [(r.num_kmers_found, r.num_query_kmer,
                  int(r.subject_info.run_accession)) for r in want[qid]]
            assert g == w
