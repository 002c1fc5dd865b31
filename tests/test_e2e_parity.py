"""End-to-end parity: FASTA -> Bloom -> database -> search hit lists.

Golden data was produced by the reference implementation (compiled
unmodified): per-accession .bloom files, transposed .db databases, and
kwage JSON/CSV outputs. This suite asserts our pipeline produces
byte-identical artifacts and outputs.
"""

import hashlib
import json

import pytest

from kwage.cli.kwage import main as kwage_main
from kwage.core import FilterInfo, str_to_accession
from kwage.io.bloom_file import read_bloom_file, write_bloom_file
from kwage.pipeline import (
    BuildOptions,
    build_bloom_from_file,
    build_db_from_bloom_files,
)


@pytest.fixture(scope="module")
def manifest(golden_dir):
    with open(golden_dir / "e2e" / "manifest.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def digests(golden_dir):
    with open(golden_dir / "e2e" / "digests.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def built(manifest, data_dir, tmp_path_factory):
    """Build all blooms + dbs with our pipeline."""
    work = tmp_path_factory.mktemp("e2e")
    opts = BuildOptions(
        kmer_len=manifest["k"],
        min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"],
        min_log_2_filter_len=manifest["minL"],
        max_log_2_filter_len=manifest["maxL"],
        min_log_2_count_len=manifest["minLc"],
        max_log_2_count_len=manifest["maxLc"],
    )
    bloom_paths = {}
    for acc in manifest["accessions"]:
        info = FilterInfo(run_accession=str_to_accession(acc))
        rec = build_bloom_from_file(str(data_dir / f"{acc}.fasta"), opts, info)
        path = work / f"{acc}.bloom"
        write_bloom_file(str(path), rec)
        bloom_paths[acc] = path

    db_paths = []
    for gi, group in enumerate(manifest["db_groups"]):
        param = read_bloom_file(str(bloom_paths[group[0]]), with_bits=False).param
        db = work / f"sra.{gi}.db"
        build_db_from_bloom_files(str(db), param, [str(bloom_paths[a]) for a in group])
        db_paths.append(db)
    return bloom_paths, db_paths


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_bloom_files_byte_identical(built, digests, manifest):
    bloom_paths, _ = built
    for acc in manifest["accessions"]:
        assert _sha(bloom_paths[acc]) == digests[f"{acc}.bloom"], acc


def test_db_files_byte_identical(built, digests, manifest):
    _, db_paths = built
    for gi, db in enumerate(db_paths):
        assert _sha(db) == digests[f"sra.{gi}.db"], f"sra.{gi}.db"


@pytest.mark.parametrize(
    "case",
    [
        "json_t1_file",
        "csv_t1_file",
        "json_t075_file",
        "csv_t075_file",
        "json_t05_file",
        "json_t1_cmdline",
        "csv_t03_cmdline",
        "json_single_query",
    ],
)
def test_search_output_byte_identical(
    case, built, manifest, golden_dir, data_dir, tmp_path, capsys
):
    _, db_paths = built
    args = []
    for db in db_paths:
        args += ["-d", str(db)]
    for a in manifest["cases"][case]:
        # Rewrite the golden-generation-time query file path to the repo copy.
        if a.endswith("queries.fasta"):
            a = str(data_dir / "queries.fasta")
        args.append(a)

    out_file = tmp_path / f"{case}.out"
    args += ["-o", str(out_file)]
    assert kwage_main(args) == 0

    with open(golden_dir / "e2e" / f"{case}.out") as f:
        want = f.read()
    with open(out_file) as f:
        got = f.read()
    assert got == want, f"{case}: output differs"

    # The fused device search path (--device) must produce the same bytes.
    dev_file = tmp_path / f"{case}.dev.out"
    assert kwage_main(args[:-2] + ["-o", str(dev_file), "--device"]) == 0
    with open(dev_file) as f:
        assert f.read() == want, f"{case}: device output differs"


def test_db_pack_chunked_byte_identical(built, tmp_path):
    """Production-L filters (L >= 22) stream through the pack in multiple
    chunks (DEFAULT_CHUNK_BITS = 2^21 < filter_len): the multi-chunk
    stream must be byte-identical to a single-chunk pack and to the
    numpy-twin transpose, at a deliberately tiny chunk so MANY chunk
    boundaries are crossed (build_db.cpp:236-315's 1 GiB tiling analog)."""
    import hashlib

    import kwage.pipeline.build_db as bdb
    from kwage.io.bloom_file import read_bloom_file

    bloom_paths, _ = built
    by_param: dict = {}
    for p in bloom_paths.values():
        by_param.setdefault(
            read_bloom_file(str(p), with_bits=False).param, []
        ).append(str(p))
    param, paths = max(by_param.items(), key=lambda kv: len(kv[1]))
    assert len(paths) >= 2

    def sha(p):
        return hashlib.sha256(open(p, "rb").read()).hexdigest()

    one = tmp_path / "one.db"
    bdb.build_db_from_bloom_files(
        str(one), param, paths, chunk_bits=param.filter_len)
    many = tmp_path / "many.db"
    bdb.build_db_from_bloom_files(
        str(many), param, paths, chunk_bits=1 << 12)
    assert sha(one) == sha(many)

    # numpy-twin transpose (native disabled) over the same chunking.
    import kwage.native as native
    orig = native.transpose_bits_native
    native.transpose_bits_native = lambda *a, **kw: None
    try:
        twin = tmp_path / "twin.db"
        bdb.build_db_from_bloom_files(
            str(twin), param, paths, chunk_bits=1 << 12)
    finally:
        native.transpose_bits_native = orig
    assert sha(twin) == sha(one)
