"""Live differential tests against the reference binaries.

These run only where the MPI-stubbed oracle build exists (/tmp/oracle,
recipe in tests/golden/README.md) -- on a clean machine they self-skip.
The golden suite covers the same surfaces with stored artifacts; this
adds randomized coverage whenever the oracle is on hand.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

ORACLE = "/tmp/oracle"

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(ORACLE, "kwage")),
    reason="reference oracle binaries not built",
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.bloom_file import write_bloom_file
    from kwage.pipeline import (
        BuildOptions,
        build_bloom_from_file,
        build_db_from_bloom_files,
    )

    work = tmp_path_factory.mktemp("oracle_live")
    rng = np.random.default_rng(99)
    opts = BuildOptions(
        kmer_len=31, min_kmer_count=1, min_log_2_filter_len=12,
        max_log_2_filter_len=20, min_log_2_count_len=12, max_log_2_count_len=20,
    )
    groups = {}
    seqs = {}
    for i in range(8):
        acc = f"SRR77{i:04d}"
        n = int(rng.integers(100, 3000))
        s = "".join(rng.choice(list("ACGTN"), p=[0.24, 0.24, 0.24, 0.24, 0.04], size=n))
        seqs[acc] = s
        fa = work / f"{acc}.fasta"
        fa.write_text(f">{acc}\n{s}\n")
        rec = build_bloom_from_file(str(fa), opts, FilterInfo(run_accession=str_to_accession(acc)))
        bl = work / f"{acc}.bloom"
        write_bloom_file(str(bl), rec)
        groups.setdefault(rec.param, []).append(str(bl))
    dbs = []
    for gi, (param, paths) in enumerate(sorted(groups.items())):
        db = work / f"sra.{gi}.db"
        build_db_from_bloom_files(str(db), param, paths)
        dbs.append(str(db))

    queries = []
    accs = list(seqs)
    for j in range(8):
        s = seqs[accs[int(rng.integers(0, len(accs)))]]
        st = int(rng.integers(0, max(1, len(s) - 120)))
        q = s[st : st + int(rng.integers(40, 120))]
        if j % 3 == 1:
            q = list(q)
            for _ in range(int(rng.integers(1, 6))):
                q[int(rng.integers(0, len(q)))] = "ACGT"[int(rng.integers(0, 4))]
            q = "".join(q)
        queries.append(q)
    qfile = work / "q.fasta"
    qfile.write_text("".join(f">q{i}\n{q}\n" for i, q in enumerate(queries)))
    return work, dbs, str(qfile)


@pytest.mark.parametrize("threshold", ["1", "0.75", "0.33", "0.01"])
@pytest.mark.parametrize("fmt", ["o.json", "o.csv"])
def test_kwage_differential(corpus, tmp_path, threshold, fmt):
    from kwage.cli.kwage import main as kwage_main

    work, dbs, qfile = corpus
    dargs = []
    for d in dbs:
        dargs += ["-d", d]
    base = dargs + ["-i", qfile, "-t", threshold, f"--{fmt}"]

    oracle_out = tmp_path / "oracle.out"
    subprocess.run(
        [os.path.join(ORACLE, "kwage")] + base + ["-o", str(oracle_out)],
        check=True, capture_output=True,
    )
    for extra in ([], ["--device"]):
        ours = tmp_path / f"ours{len(extra)}.out"
        assert kwage_main(base + ["-o", str(ours)] + extra) == 0
        assert ours.read_bytes() == oracle_out.read_bytes(), (threshold, fmt, extra)


def test_kwage_mixed_cmdline_and_file_queries(corpus, tmp_path):
    """Command-line sequences and -i files share one database pass but
    separate query-id spaces (kwage.cpp:116-148); output must still match
    the reference byte for byte."""
    from kwage.cli.kwage import main as kwage_main

    work, dbs, qfile = corpus
    seqs = ["ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT", "GGGTTTAAACCCGGGTTTAAACCCGGGTTTAAACCC"]
    dargs = []
    for d in dbs:
        dargs += ["-d", d]
    base = dargs + ["-i", qfile, "-t", "0.3", "--o.json"] + seqs

    oracle_out = tmp_path / "oracle.out"
    subprocess.run(
        [os.path.join(ORACLE, "kwage")] + base + ["-o", str(oracle_out)],
        check=True, capture_output=True,
    )
    for extra in ([], ["--device"]):
        ours = tmp_path / f"mixed{len(extra)}.out"
        assert kwage_main(base + ["-o", str(ours)] + extra) == 0
        assert ours.read_bytes() == oracle_out.read_bytes(), extra


def test_dump_tools_differential(corpus, tmp_path):
    # Compare stdout to stdout: the reference prints two informational
    # lines with cout unconditionally (dump_db.cpp:193-195), so the -o
    # file is NOT the full transcript on either implementation.
    work, dbs, _ = corpus
    for db in dbs:
        oracle = subprocess.run(
            [os.path.join(ORACLE, "dump_db"), "-i", db],
            check=True, capture_output=True, text=True,
        ).stdout
        ours = subprocess.run(
            [sys.executable, "-m", "kwage.cli.dump_db", "-i", db],
            check=True, capture_output=True, text=True,
        ).stdout
        assert ours == oracle


def test_bloom_diff_differential(corpus, tmp_path):
    work, dbs, _ = corpus
    blooms = sorted(str(p) for p in work.glob("*.bloom"))[:2]
    oracle = subprocess.run(
        [os.path.join(ORACLE, "bloom_diff"), blooms[0], blooms[1]],
        capture_output=True, text=True,
    )
    ours = subprocess.run(
        [sys.executable, "-m", "kwage.cli.bloom_diff", blooms[0], blooms[1]],
        capture_output=True, text=True,
    )
    assert ours.stdout == oracle.stdout
    assert ours.returncode == oracle.returncode


def test_dump_bloom_differential(corpus, tmp_path):
    work, dbs, _ = corpus
    bloom = sorted(str(p) for p in work.glob("*.bloom"))[0]
    oracle = subprocess.run(
        [os.path.join(ORACLE, "dump_bloom"), bloom],
        check=True, capture_output=True, text=True,
    ).stdout
    ours = subprocess.run(
        [sys.executable, "-m", "kwage.cli.dump_bloom", bloom],
        check=True, capture_output=True, text=True,
    ).stdout
    assert ours == oracle


def test_inventory_dump_and_sra_diff_differential(tmp_path):
    """inventory_dump transcript + sra_diff accession-set diff vs oracle."""
    import numpy as np

    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.inventory import write_inventory

    rng = np.random.default_rng(17)

    def make_inv(path, accs):
        infos = []
        for a in accs:
            info = FilterInfo(run_accession=str_to_accession(a))
            info.number_of_spots = int(rng.integers(1, 100))
            info.number_of_bases = int(rng.integers(100, 10000))
            info.experiment_title = f"exp {a}"
            infos.append(info)
        write_inventory(str(path), infos)

    inv1 = tmp_path / "a.bin"
    inv2 = tmp_path / "b.bin"
    make_inv(inv1, ["SRR100", "SRR200", "SRR300"])
    make_inv(inv2, ["SRR200", "SRR400"])

    for tool, args in (
        ("inventory_dump", [str(inv1)]),
        ("sra_diff", [str(inv1), str(inv2)]),
    ):
        oracle = subprocess.run(
            [os.path.join(ORACLE, tool)] + args, capture_output=True, text=True
        )
        ours = subprocess.run(
            [sys.executable, "-m", f"kwage.cli.{tool}"] + args,
            capture_output=True, text=True,
        )
        assert ours.stdout == oracle.stdout, tool


@pytest.mark.parametrize("k", [15, 21, 32])
def test_edge_kmer_lengths_differential(tmp_path, k):
    """k=15 (single-word device domain), 21 (tail-block murmur), 32 (word
    fills all 64 bits; the sort-sentinel edge): device build == host build
    bit-for-bit, and search output == the reference binary."""
    from kwage.cli.kwage import main as kwage_main
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.bloom_file import write_bloom_file
    from kwage.io.sequence import iter_sequences
    from kwage.pipeline import (
        BuildOptions,
        build_bloom_device,
        build_bloom_from_file,
        build_db_from_bloom_files,
    )

    rng = np.random.default_rng(7 + k)
    opts = BuildOptions(
        kmer_len=k, min_kmer_count=1, min_log_2_filter_len=12,
        max_log_2_filter_len=18, min_log_2_count_len=12, max_log_2_count_len=18,
    )
    groups = {}
    for i in range(3):
        acc = f"SRR9{k:02d}{i:03d}"
        s = "".join(rng.choice(list("ACGTN"), p=[0.24] * 4 + [0.04],
                               size=int(rng.integers(200, 1500))))
        fa = tmp_path / f"{acc}.fasta"
        fa.write_text(f">{acc}\n{s}\n")
        rec = build_bloom_from_file(str(fa), opts, FilterInfo(run_accession=str_to_accession(acc)))
        dev = build_bloom_device(
            (q for _, q in iter_sequences(str(fa))), opts,
            FilterInfo(run_accession=str_to_accession(acc)),
        )
        assert dev.param == rec.param and dev.bits.tobytes() == rec.bits.tobytes()
        bl = tmp_path / f"{acc}.bloom"
        write_bloom_file(str(bl), rec)
        groups.setdefault(rec.param, []).append(str(bl))
    dbs = []
    for gi, (param, paths) in enumerate(sorted(groups.items())):
        db = tmp_path / f"sra.{gi}.db"
        build_db_from_bloom_files(str(db), param, paths)
        dbs.append(str(db))
    qfile = tmp_path / "q.fasta"
    qfile.write_text(f">q\n{s[20:140]}\n")

    dargs = []
    for d in dbs:
        dargs += ["-d", d]
    base = dargs + ["-i", str(qfile), "-t", "0.4", "--o.json"]
    oracle_out = tmp_path / "o.json"
    subprocess.run([os.path.join(ORACLE, "kwage")] + base + ["-o", str(oracle_out)],
                   check=True, capture_output=True)
    for extra in ([], ["--device"]):
        ours = tmp_path / f"m{len(extra)}.json"
        assert kwage_main(base + ["-o", str(ours)] + extra) == 0
        assert ours.read_bytes() == oracle_out.read_bytes(), (k, extra)


def test_options_stage_exit_codes_match_reference(tmp_path):
    """The reference exits 0 (EXIT_SUCCESS) on every options-stage
    rejection -- quit + stderr message, kwage.cpp:44-46. Scripted callers
    key off output, not the exit code; ours must match."""
    import subprocess as sp

    empty = tmp_path / "empty"
    empty.mkdir()
    cases = [
        ["-d", str(empty), "ACGTACGTACGTACGTACGTACGTACGTACGT"],  # no .db found
        ["-d", str(empty)],                                      # no query
        ["-d", str(empty), "-t", "2.0", "ACGT"],                 # bad threshold
    ]
    for extra in cases:
        oracle = sp.run([os.path.join(ORACLE, "kwage")] + extra,
                        capture_output=True, text=True)
        ours = sp.run([sys.executable, "-m", "kwage.cli.kwage"] + extra,
                      capture_output=True, text=True)
        assert ours.returncode == oracle.returncode == 0, extra


def test_quirky_extension_matching_matches_reference(corpus, tmp_path):
    """find_file_extension quirk (file_util.cpp): the FIRST case-insensitive
    occurrence of the extension anywhere in the path must END the string,
    so a database under a '.db'-containing directory is INVISIBLE. Both
    engines must agree on hidden and visible layouts."""
    import shutil
    import subprocess as sp

    _work, dbs, _q = corpus
    db = dbs[0]
    hidden_dir = tmp_path / "runs.db"
    visible_dir = tmp_path / "runs_db"
    hidden_dir.mkdir()
    visible_dir.mkdir()
    shutil.copy(db, hidden_dir / "sra.1.db")
    shutil.copy(db, visible_dir / "sra.1.db")
    q = "ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT"

    for d, expect_hidden in ((hidden_dir, True), (visible_dir, False)):
        oracle = sp.run(
            [os.path.join(ORACLE, "kwage"), "-d", str(d / "sra.1.db"),
             "-t", "0.5", q], capture_output=True, text=True)
        ours = sp.run(
            [sys.executable, "-m", "kwage.cli.kwage", "-d",
             str(d / "sra.1.db"), "-t", "0.5", q],
            capture_output=True, text=True)
        hidden_msg = "Please provide at least one database file"
        assert (hidden_msg in oracle.stderr) == expect_hidden, (d, oracle.stderr)
        assert (hidden_msg in ours.stderr) == expect_hidden, (d, ours.stderr)
        assert ours.returncode == oracle.returncode == 0
        if not expect_hidden:
            assert ours.stdout == oracle.stdout
