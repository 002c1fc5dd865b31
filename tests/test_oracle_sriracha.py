"""Live differential fuzz of the SriRachA per-read kernel vs the
UNMODIFIED reference kernel (search_by_kmer.cpp:14-135).

The reference binary itself only reads .sra inputs, so a harness
(tests/golden/sriracha_oracle_harness.cpp) drives the reference kernel
object files over local files with main.cpp's subject loading and final
cull; scores print in C `%a` hex for bit-exact float32 comparison.
Auto-builds into /tmp/oracle_sriracha when /root/reference is present;
self-skips otherwise.

Covered differentially: canonical k-mer profiles (N resets, lowercase),
the min_valid_kmer and float32 complexity gates, per-subject lower_bound
intersection counts, float32 score thresholding, perfect-match culling,
the 10x overflow cull, and the final descending-score /
ascending-read-index order -- through BOTH our native C kernel and the
pure-numpy twin.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

REF = "/root/reference/SriRachA"
ORACLE_DIR = "/tmp/oracle_sriracha"
ORACLE = os.path.join(ORACLE_DIR, "sriracha_oracle")
HARNESS = os.path.join(os.path.dirname(__file__), "golden",
                       "sriracha_oracle_harness.cpp")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference sources not present")


@pytest.fixture(scope="module")
def oracle():
    if os.path.exists(ORACLE):
        return ORACLE
    os.makedirs(ORACLE_DIR, exist_ok=True)
    mpi_stub = os.path.join(ORACLE_DIR, "mpi.h")
    if not os.path.exists(mpi_stub):
        if os.path.exists("/tmp/oracle/mpi.h"):
            with open("/tmp/oracle/mpi.h") as f:
                stub = f.read()
        else:
            stub = (
                "#ifndef MPI_STUB_H\n#define MPI_STUB_H\n"
                "typedef int MPI_Comm, MPI_Datatype, MPI_Op, MPI_Status,"
                " MPI_Request;\n#define MPI_COMM_WORLD 0\n#define MPI_BYTE 0\n"
                "#define MPI_SUCCESS 0\n"
                "inline int MPI_Bcast(void*, int, MPI_Datatype, int,"
                " MPI_Comm){return 0;}\n"
                "inline int MPI_Init(int*, char***){return 0;}\n"
                "inline int MPI_Finalize(){return 0;}\n"
                "inline int MPI_Abort(MPI_Comm, int){return 0;}\n"
                "inline int MPI_Comm_size(MPI_Comm, int* n){*n=1; return 0;}\n"
                "inline int MPI_Comm_rank(MPI_Comm, int* r){*r=0; return 0;}\n"
                "inline double MPI_Wtime(){return 0.0;}\n#endif\n")
        with open(mpi_stub, "w") as f:
            f.write(stub)
    objs = []
    try:
        for unit in ["word", "parse_sequence", "file_util", "ifind",
                     "search_by_kmer"]:
            obj = os.path.join(ORACLE_DIR, unit + ".o")
            subprocess.run(
                ["g++", "-O2", "-w", "-std=c++11", "-I", ORACLE_DIR,
                 "-I", REF, "-c", os.path.join(REF, unit + ".cpp"),
                 "-o", obj], check=True, capture_output=True)
            objs.append(obj)
        hobj = os.path.join(ORACLE_DIR, "harness.o")
        subprocess.run(
            ["g++", "-O2", "-w", "-std=c++11", "-I", ORACLE_DIR, "-I", REF,
             "-c", HARNESS, "-o", hobj], check=True, capture_output=True)
        subprocess.run(
            ["g++", "-O2", "-o", ORACLE, hobj] + objs + ["-lz"],
            check=True, capture_output=True)
    except subprocess.CalledProcessError as e:
        pytest.skip(f"oracle harness build failed: {e.stderr[:500]}")
    return ORACLE


def _run_oracle(oracle_bin, k, thr, comp, min_len, min_valid, max_match,
                subj_path, reads_path):
    proc = subprocess.run(
        [oracle_bin, str(k), repr(thr), repr(comp), str(min_len),
         str(min_valid), str(max_match), subj_path, reads_path],
        capture_output=True, text=True, check=True)
    per_subject: dict[int, list] = {}
    for line in proc.stdout.splitlines():
        s, ridx, sub, score_hex, seq = line.split("\t")
        per_subject.setdefault(int(s), []).append(
            (int(ridx), int(sub), np.float32(float.fromhex(score_hex)), seq))
    return per_subject


def _ours(subj_path, reads_path, k, thr, comp, min_len, min_valid,
          max_match, pure_python):
    import kwage.sriracha.engine as eng
    from kwage.sriracha.engine import SrirachaOptions, load_subject_kmers

    opt = SrirachaOptions(
        kmer_len=k, kmer_match_threshold=thr, min_read_complexity=comp,
        min_read_length=min_len, min_valid_kmer=min_valid,
        max_num_match=max_match,
        use_device=(pure_python == "device"))
    subjects = load_subject_kmers([subj_path], k)
    if pure_python is True:
        orig = (eng.native_available, eng.read_profile_native,
                eng.sorted_intersect_count_native)
        eng.native_available = lambda: False
        eng.read_profile_native = lambda seq, kk: None
        eng.sorted_intersect_count_native = lambda uniq, subject: None
        try:
            res = eng.search_accession(reads_path, subjects, opt)
        finally:
            (eng.native_available, eng.read_profile_native,
             eng.sorted_intersect_count_native) = orig
    else:
        res = eng.search_accession(reads_path, subjects, opt)
    return {
        s: [(m.read_index, m.read_subindex, np.float32(m.score), m.read_seq)
            for m in bucket]
        for s, bucket in enumerate(res) if bucket
    }


def _rseq(rng, n, alpha="ACGT"):
    return "".join(rng.choice(alpha) for _ in range(n))


def test_kernel_matches_reference_fuzz(oracle, tmp_path):
    rng = random.Random(20260817)
    for trial in range(10):
        k = rng.choice([7, 11, 21, 31, 32])
        thr = rng.choice([0.2, 0.5, 1.0])
        comp = rng.choice([0.0, 0.5, 0.75])
        min_len = rng.choice([0, 60])
        min_valid = rng.choice([1, 10])
        max_match = rng.choice([3, 100000])
        targets = [_rseq(rng, rng.randint(400, 2500))
                   for _ in range(rng.randint(1, 4))]
        subj = tmp_path / f"s{trial}.fasta"
        subj.write_text("".join(
            f">t{i}\n{t}\n" for i, t in enumerate(targets)))
        reads = []
        for _ in range(300):
            r = rng.random()
            if r < 0.35:        # planted hit
                t = rng.choice(targets)
                a = rng.randint(0, max(0, len(t) - 150))
                reads.append(t[a:a + 150])
            elif r < 0.45:      # noisy hit (Ns + substitutions)
                t = rng.choice(targets)
                a = rng.randint(0, max(0, len(t) - 150))
                s = list(t[a:a + 150])
                for _ in range(12):
                    s[rng.randrange(len(s))] = rng.choice("ACGTN")
                reads.append("".join(s))
            elif r < 0.55:      # low complexity
                reads.append("AC" * 75)
            elif r < 0.62:      # short / empty
                reads.append(_rseq(rng, rng.randint(0, 40)))
            elif r < 0.70:      # lowercase planted hit
                t = rng.choice(targets)
                a = rng.randint(0, max(0, len(t) - 150))
                reads.append(t[a:a + 150].lower())
            else:               # random
                reads.append(_rseq(rng, 150))
        reads_path = tmp_path / f"r{trial}.fasta"
        reads_path.write_text("".join(
            f">r{i}\n{s}\n" for i, s in enumerate(reads)))

        want = _run_oracle(oracle, k, thr, comp, min_len, min_valid,
                           max_match, str(subj), str(reads_path))
        # Three engine legs vs the live reference kernel: native host,
        # pure-python twin, and the batched device path (vectorized
        # gates + span pipeline) on the test mesh.
        legs = [False, True] + (["device"] if trial < 4 else [])
        for pure in legs:
            got = _ours(str(subj), str(reads_path), k, thr, comp, min_len,
                        min_valid, max_match, pure)
            case = (trial, k, thr, comp, min_len, min_valid, max_match, pure)
            assert got == want, case


def test_kernel_matches_reference_fastq_and_gz(oracle, tmp_path):
    """Same differential through FASTQ and gzip parsing."""
    import gzip

    rng = random.Random(7)
    target = _rseq(rng, 1200)
    subj = tmp_path / "s.fasta"
    subj.write_text(f">t\n{target}\n")
    reads = []
    for i in range(120):
        a = rng.randint(0, 1050)
        reads.append(target[a:a + 150] if i % 2 else _rseq(rng, 150))
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(
        f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))
    fqgz = tmp_path / "r2.fastq.gz"
    with gzip.open(fqgz, "wt") as f:
        f.write("".join(
            f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))

    for path in (fq, fqgz):
        want = _run_oracle(oracle, 21, 0.5, 0.75, 0, 1, 100000,
                           str(subj), str(path))
        got = _ours(str(subj), str(path), 21, 0.5, 0.75, 0, 1, 100000, False)
        assert got == want, path.name
