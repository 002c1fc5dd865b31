"""Core numerics vs reference-oracle golden values.

The golden file was produced by running the reference KWAGE code (compiled
unmodified) over randomized inputs; these tests pin bit-exact parity of the
k-mer codec, murmur3-32 multi-seed hashing, the Bloom parameter solver and
the accession codec.
"""

import json

import numpy as np
import pytest

from kwage.core import (
    accession_to_str,
    approximate_max_kmers,
    canonical_kmers,
    murmur32_string,
    murmur32_words,
    optimal_bloom_param,
    str_to_accession,
    word_to_string,
    string_to_word,
)
from kwage.core.words import sense_antisense_words


def _golden(golden_dir):
    with open(golden_dir / "core_golden.json") as f:
        return json.load(f)


def test_canonical_kmers_match_oracle(golden_dir):
    g = _golden(golden_dir)
    for case in g["kmers"]:
        k, seq = case["k"], case["seq"]
        got = canonical_kmers(seq, k)
        want_locs = [r[0] for r in case["rows"]]
        want_words = [r[1] for r in case["rows"]]
        assert got.tolist() == want_words, f"k={k} seq={seq}"
        # positions of valid windows must match Loc5
        _, _, valid = sense_antisense_words(seq, k)
        assert np.nonzero(valid)[0].tolist() == want_locs


def test_hash_matches_oracle(golden_dir):
    g = _golden(golden_dir)
    for case in g["hash"]:
        words = np.array([case["word"]], dtype=np.uint64)
        got = murmur32_words(words, case["k"], case["num_seeds"])[0]
        assert got.tolist() == case["values"], case


def test_string_hash_matches_oracle(golden_dir):
    g = _golden(golden_dir)
    for case in g["hashstr"]:
        assert murmur32_string(case["s"], case["seed"]) == case["value"]


def test_word_hash_equals_string_hash():
    # The 2-bit word hash must equal murmur over the decoded ASCII k-mer.
    rng = np.random.default_rng(0)
    for k in (5, 16, 31, 32):
        words = rng.integers(0, 1 << min(2 * k, 63), size=8, dtype=np.uint64)
        h = murmur32_words(words, k, 3)
        for i, w in enumerate(words):
            s = word_to_string(int(w), k)
            assert string_to_word(s) == int(w) & ((1 << (2 * k)) - 1 if k < 32 else (1 << 64) - 1)
            for seed in range(3):
                assert murmur32_string(s, seed) == int(h[i, seed])


def test_param_solver_matches_oracle(golden_dir):
    g = _golden(golden_dir)
    for case in g["param"]:
        if case["out"] == "none":
            with pytest.raises(ValueError):
                optimal_bloom_param(
                    31, case["num_kmer"], case["fp"],
                    min_log_2_filter_len=case["minL"],
                    max_log_2_filter_len=case["maxL"],
                )
        else:
            L, h = map(int, case["out"].split())
            p = optimal_bloom_param(
                31, case["num_kmer"], case["fp"],
                min_log_2_filter_len=case["minL"],
                max_log_2_filter_len=case["maxL"],
            )
            assert (p.log_2_filter_len, p.num_hash) == (L, h), case


def test_max_kmers_matches_oracle(golden_dir):
    g = _golden(golden_dir)
    for case in g["maxkmers"]:
        got = approximate_max_kmers(
            case["fp"],
            min_log_2_filter_len=case["minL"],
            max_log_2_filter_len=case["maxL"],
        )
        assert got == case["value"], case


def test_accession_codec_matches_oracle(golden_dir):
    g = _golden(golden_dir)
    for case in g["acc"]:
        packed = str_to_accession(case["s"])
        assert packed == case["packed"], case
        assert accession_to_str(packed) == case["roundtrip"]


def test_accession_fast_path_matches_general_loop():
    """str_to_accession's NCBI-shape fast path == the general scan loop
    (sra_accession.cpp:27-96 semantics) across the legal space and on
    malformed inputs that must fall through to the general parser."""
    import random

    import pytest

    from kwage.core.accession import accession_to_str, str_to_accession

    def general(accession):
        nl = nd = 0
        data = 0
        for ch in accession:
            u = ch.upper()
            if "A" <= u <= "Z":
                nl += 1
                data = data * 26 + (ord(u) - 65)
            elif "0" <= ch <= "9":
                nd += 1
                data = data * 10 + (ord(ch) - 48)
        if nl != 3 or nd == 0 or nd > 10:
            raise ValueError(accession)
        ret = (nd - 1) | (data << 4)
        if ret == 0:
            raise ValueError(accession)
        return ret & 0xFFFFFFFFFFFFFFFF

    random.seed(3)
    for _ in range(3000):
        p = "".join(random.choice("ABCDEFGHIJKLMNOPQRSTUVWXYZ") for _ in range(3))
        d = "".join(random.choice("0123456789")
                    for _ in range(random.randint(1, 10)))
        a = p + d
        v = str_to_accession(a)
        assert v == general(a)
        assert accession_to_str(v) == a
    for a in ["srr123", "SRR-00123", "S1R123", "SRRabc123", "DRX0000001"]:
        try:
            want = general(a)
        except ValueError:
            want = "err"
        try:
            got = str_to_accession(a)
        except ValueError:
            got = "err"
        assert got == want, a
