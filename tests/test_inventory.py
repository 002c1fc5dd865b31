"""sra_inventory pipeline over a synthetic NCBI metadata tarball, plus
manual_db status patching and the bff factory rig."""

import io
import json
import os
import tarfile

import numpy as np
import pytest

from kwage.core import Date, FilterInfo, accession_to_str, str_to_accession
from kwage.io.inventory import read_inventory
from kwage.pipeline.inventory import (
    InventoryFilters,
    build_inventory,
    parse_sra_metadata,
)


def _add(tf, name, text):
    data = text.encode()
    ti = tarfile.TarInfo(name)
    ti.size = len(data)
    tf.addfile(ti, io.BytesIO(data))


@pytest.fixture()
def metadata_tar(tmp_path):
    """A miniature NCBI SRA metadata archive."""
    path = tmp_path / "NCBI_SRA_Metadata.tar.gz"
    header = "\t".join(
        ["Accession", "Submission", "Status", "Updated", "Published", "Received",
         "Type", "Center", "Visibility", "Alias", "Experiment", "Sample", "Study",
         "Loaded", "Spots", "Bases"]
    )

    def run_row(acc, status, received, exp, samp, study, spots, bases, vis="public", center="LANL"):
        return "\t".join(
            [acc, "SUB1", status, "2020-01-01", "2020-01-02", received, "RUN",
             center, vis, "-", exp, samp, study, "1", str(spots), str(bases)]
        )

    tab = "\n".join([
        header,
        run_row("SRR0000001", "live", "2019-05-01T10:00:00Z", "SRX0000001", "SRS0000001", "SRP0000001", 10, 1000),
        run_row("SRR0000002", "live", "2020-06-15T10:00:00Z", "SRX0000002", "SRS0000002", "SRP0000001", 20, 2000),
        run_row("SRR0000003", "suppressed", "2020-06-15T10:00:00Z", "SRX0000002", "SRS0000002", "SRP0000001", 5, 500),
        run_row("SRR0000004", "live", "2021-01-01T10:00:00Z", "SRX0000003", "-", "-", 7, 700),
        "\t".join(["SRX0000001", "SUB1", "live", "-", "-", "2019-05-01T10:00:00Z",
                   "EXPERIMENT", "LANL", "public", "-", "-", "-", "-", "1", "-", "-"]),
    ]) + "\n"

    exp_xml = """<EXPERIMENT_SET>
<EXPERIMENT accession="SRX0000001" alias="e1">
<TITLE>Experiment one title</TITLE>
<DESIGN_DESCRIPTION>shotgun design</DESIGN_DESCRIPTION>
<LIBRARY_NAME>lib1</LIBRARY_NAME>
<LIBRARY_STRATEGY>WGS</LIBRARY_STRATEGY>
<LIBRARY_SOURCE>GENOMIC</LIBRARY_SOURCE>
<LIBRARY_SELECTION>RANDOM</LIBRARY_SELECTION>
<INSTRUMENT_MODEL>Illumina NovaSeq 6000</INSTRUMENT_MODEL>
</EXPERIMENT>
<EXPERIMENT accession="SRX0000002" alias="e2">
<TITLE>Experiment two title</TITLE>
<LIBRARY_STRATEGY>RNA-Seq</LIBRARY_STRATEGY>
<LIBRARY_SOURCE>TRANSCRIPTOMIC</LIBRARY_SOURCE>
</EXPERIMENT>
<EXPERIMENT accession="SRX0000003" alias="e3">
<TITLE>Controlled</TITLE>
<EXTERNAL_ID namespace="dbgap">phs000000</EXTERNAL_ID>
</EXPERIMENT>
</EXPERIMENT_SET>
"""
    sample_xml = """<SAMPLE_SET>
<SAMPLE accession="SRS0000001" alias="s1">
<SCIENTIFIC_NAME>Escherichia coli</SCIENTIFIC_NAME>
<SAMPLE_ATTRIBUTE>
<TAG>isolation_source</TAG>
<VALUE>soil</VALUE>
</SAMPLE_ATTRIBUTE>
<SAMPLE_ATTRIBUTE>
<TAG>BioSampleModel</TAG>
<VALUE>Microbe</VALUE>
</SAMPLE_ATTRIBUTE>
</SAMPLE>
</SAMPLE_SET>
"""
    study_xml = """<STUDY_SET>
<STUDY accession="SRP0000001" alias="p1">
<STUDY_TITLE>A study of things</STUDY_TITLE>
<STUDY_ABSTRACT>We studied the things.</STUDY_ABSTRACT>
</STUDY>
</STUDY_SET>
"""
    with tarfile.open(path, "w:gz") as tf:
        _add(tf, "SRA_Accessions", tab)
        _add(tf, "SUB1/SUB1.experiment.xml", exp_xml)
        _add(tf, "SUB1/SUB1.sample.xml", sample_xml)
        _add(tf, "SUB1/SUB1.study.xml", study_xml)
    return str(path)


def test_parse_metadata(metadata_tar):
    db, attrs = parse_sra_metadata(metadata_tar, verbose=False)
    # suppressed SRR0000003 dropped at the tab stage
    accs = [accession_to_str(r.run_accession) for r in db]
    assert accs == ["SRR0000001", "SRR0000002", "SRR0000004"]

    r1 = db[0]
    assert r1.experiment_title == "Experiment one title"
    assert r1.experiment_library_strategy == "WGS"
    assert r1.experiment_library_source == "GENOMIC"
    assert r1.experiment_instrument_model == "Illumina NovaSeq 6000"
    assert r1.sample_taxa == "Escherichia coli"
    assert r1.study_title == "A study of things"
    assert r1.study_abstract == "We studied the things."
    assert r1.number_of_spots == 10 and r1.number_of_bases == 1000
    assert r1.date_received == Date(1, 5, 2019)
    # Center column becomes a sample attribute
    assert r1.sample_attributes == {"Center": "LANL"}
    # dbgap-linked experiment marks the run invalid
    assert db[2].valid is False
    # sample attributes accumulate per sample accession, BioSampleModel excluded
    assert attrs[str_to_accession("SRS0000001")] == {"isolation_source": "soil"}


def test_build_inventory_with_filters(metadata_tar, tmp_path):
    out = tmp_path / "inv.bin"
    n = build_inventory(
        metadata_tar, str(out),
        InventoryFilters(required_strategy={"WGS"}),
        verbose=False,
    )
    assert n == 1
    infos = read_inventory(str(out))
    assert accession_to_str(infos[0].run_accession) == "SRR0000001"
    # injected sample attributes include both Center and the XML attribute
    assert infos[0].sample_attributes == {"Center": "LANL", "isolation_source": "soil"}


def test_build_inventory_date_filter(metadata_tar, tmp_path):
    out = tmp_path / "inv.bin"
    n = build_inventory(
        metadata_tar, str(out),
        InventoryFilters(begin_date=Date(1, 1, 2020)),
        verbose=False,
    )
    infos = read_inventory(str(out))
    assert [accession_to_str(i.run_accession) for i in infos] == ["SRR0000002"]
    assert n == 1


def test_inventory_sorted_by_bases(metadata_tar, tmp_path):
    out = tmp_path / "inv.bin"
    build_inventory(metadata_tar, str(out), verbose=False)
    infos = read_inventory(str(out))
    bases = [i.number_of_bases for i in infos]
    assert bases == sorted(bases)


def test_manual_db(metadata_tar, tmp_path, data_dir, golden_dir):
    """manual_db marks a database's accessions DATABASE_SUCCESS."""
    import json

    from kwage.cli.manual_db import main as manual_db_main
    from kwage.core import FilterInfo
    from kwage.io.inventory import write_inventory
    from kwage.io.bloom_file import read_bloom_file, write_bloom_file
    from kwage.io.status import read_status_file
    from kwage.pipeline import BuildOptions, build_bloom_from_file, build_db_from_bloom_files

    with open(golden_dir / "e2e" / "manifest.json") as f:
        manifest = json.load(f)
    opts = BuildOptions(
        kmer_len=manifest["k"], min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"],
        min_log_2_filter_len=manifest["minL"], max_log_2_filter_len=manifest["maxL"],
        min_log_2_count_len=manifest["minLc"], max_log_2_count_len=manifest["maxLc"],
    )
    group = manifest["db_groups"][2]
    blooms = []
    for acc in group:
        rec = build_bloom_from_file(
            str(data_dir / f"{acc}.fasta"), opts,
            FilterInfo(run_accession=str_to_accession(acc)))
        p = tmp_path / f"{acc}.bloom"
        write_bloom_file(str(p), rec)
        blooms.append(str(p))
    param = read_bloom_file(blooms[0], with_bits=False).param
    db_path = tmp_path / "x.db"
    build_db_from_bloom_files(str(db_path), param, blooms)

    inv = tmp_path / "inv.bin"
    write_inventory(str(inv), [
        FilterInfo(run_accession=str_to_accession(a)) for a in manifest["accessions"]
    ])
    status_path = tmp_path / "status.bin"
    rc = manual_db_main(["-d", str(db_path), "-s", str(status_path), "--meta", str(inv)])
    assert rc == 0
    status, _ = read_status_file(str(status_path), len(manifest["accessions"]))
    # accessions sorted; group members marked 17, everyone else INIT
    sorted_accs = sorted(manifest["accessions"])
    for i, acc in enumerate(sorted_accs):
        assert status[i] == (17 if acc in group else 1), acc


def test_bff(tmp_path, data_dir, golden_dir, capsys):
    import json

    from kwage.cli.bff import main as bff_main

    with open(golden_dir / "e2e" / "manifest.json") as f:
        manifest = json.load(f)
    acc = manifest["accessions"][0]
    rc = bff_main([
        "-k", str(manifest["k"]), "--min-kmer-count", str(manifest["min_kmer_count"]),
        "--len.min", str(manifest["minL"]), "--len.max", str(manifest["maxL"]),
        "--count-len.min", str(manifest["minLc"]), "--count-len.max", str(manifest["maxLc"]),
        "-o", str(tmp_path), "--source-dir", str(data_dir), acc,
    ])
    assert rc == 0
    assert (tmp_path / f"{acc}.bloom").exists()
    err = capsys.readouterr().err
    assert "L=13" in err and "crc32=237c27cb" in err


def test_inventory_matches_reference_binary(metadata_tar, tmp_path, golden_dir):
    """Byte-level oracle check: tests/golden/inventory/oracle_inv.bin was
    produced by the reference sra_inventory binary (MPI-stubbed build, see
    tests/golden/README.md) on this exact fixture tar. Every field must
    match; sample_attributes compare as dicts because the reference
    serializes a std::unordered_map, whose element ORDER is incidental
    hash-bucket iteration (bloom.h:17), not part of the format contract."""
    from kwage.pipeline.inventory import InventoryFilters, build_inventory

    out = tmp_path / "inv.bin"
    build_inventory(metadata_tar, str(out), InventoryFilters(), verbose=False)

    ours = read_inventory(str(out))
    oracle = read_inventory(str(golden_dir / "inventory" / "oracle_inv.bin"))
    assert len(ours) == len(oracle) == 2
    for a, b in zip(ours, oracle):
        for field in (
            "run_accession", "experiment_accession", "sample_accession",
            "study_accession", "experiment_title", "experiment_design_description",
            "experiment_library_name", "experiment_library_strategy",
            "experiment_library_source", "experiment_library_selection",
            "experiment_instrument_model", "sample_taxa", "study_title",
            "study_abstract", "number_of_spots", "number_of_bases",
            "date_received",
        ):
            assert getattr(a, field) == getattr(b, field), field
        assert dict(a.sample_attributes) == dict(b.sample_attributes)


def test_native_inventory_matches_python_twin(metadata_tar, tmp_path, monkeypatch):
    """kn_build_inventory (the whole two-pass build in C) is byte-identical
    to the Python path across filter combinations, and raises the same
    way on malformed archives."""
    import tarfile

    import pytest

    import kwage.pipeline.inventory as inv
    from kwage.native import available

    if not available():
        pytest.skip("native library unavailable")

    def both(filters):
        a = tmp_path / "native.bin"
        b = tmp_path / "python.bin"
        na = build_inventory(metadata_tar, str(a), filters, verbose=False)
        monkeypatch.setattr(
            "kwage.native.build_inventory_native",
            lambda *args, **kw: None)
        try:
            nb = build_inventory(metadata_tar, str(b), filters, verbose=False)
        finally:
            monkeypatch.undo()
        assert na == nb
        assert a.read_bytes() == b.read_bytes()
        return na

    assert both(None) == 2  # dbgap run filtered
    assert both(InventoryFilters(required_strategy={"WGS"})) == 1
    assert both(InventoryFilters(required_source={"GENOMIC"})) == 1
    assert both(InventoryFilters(begin_date=Date(1, 1, 2020))) == 1
    assert both(InventoryFilters(end_date=Date(31, 12, 2019))) == 1
    assert both(InventoryFilters(
        include_accessions=[str_to_accession("SRR0000002"),
                            str_to_accession("SRR0000004")])) == 1
    assert both(InventoryFilters(required_strategy={"nope"})) == 0

    # Malformed archive: both paths raise.
    bad = tmp_path / "bad.tar.gz"
    with tarfile.open(bad, "w:gz") as tf:
        import io as _io
        data = b"not\ta\tvalid\theader\nrow\n"
        ti = tarfile.TarInfo("SRA_Accessions")
        ti.size = len(data)
        tf.addfile(ti, _io.BytesIO(data))
    with pytest.raises(ValueError):
        build_inventory(str(bad), str(tmp_path / "x.bin"), verbose=False)
    # No SRA_Accessions member at all.
    empty = tmp_path / "empty.tar.gz"
    with tarfile.open(empty, "w:gz") as tf:
        pass
    with pytest.raises(ValueError):
        build_inventory(str(empty), str(tmp_path / "y.bin"), verbose=False)


def test_native_inventory_fuzz_vs_twin(tmp_path, monkeypatch):
    """Randomized archive shapes: long member names, multi-line XML
    records, repeated samples across runs, attribute overrides, lowercase
    accessions in XML, '-' fields -- native and Python paths byte-equal."""
    import io
    import random
    import tarfile

    import kwage.pipeline.inventory as inv
    from kwage.native import available

    import pytest

    if not available():
        pytest.skip("native library unavailable")
    random.seed(8)
    header = "\t".join(
        ["Accession", "Submission", "Status", "Updated", "Published",
         "Received", "Type", "Center", "Visibility", "Alias", "Experiment",
         "Sample", "Study", "Loaded", "Spots", "Bases"])
    for trial in range(4):
        rows = [header]
        exps, samps, studies = [], [], []
        for i in range(1, 60):
            gid = trial * 100 + i
            samp = f"SRS{(gid // 2):07d}"   # samples shared by run pairs
            status = random.choice(["live", "live", "live", "suppressed"])
            center = random.choice(["LANL", "-", "JGI"])
            spots = random.choice(["-", str(i * 10)])
            bases = random.choice(["-", str((i % 7) * 1000)])  # tie-heavy
            rows.append("\t".join(
                [f"SRR{gid:07d}", f"SUB{trial}", status, "2020-01-01",
                 "2020-01-02", f"2020-{(i % 12) + 1:02d}-03T01:02:03Z",
                 "RUN", center, "public", "-", f"SRX{gid:07d}", samp,
                 f"SRP{trial:07d}", "1", spots, bases]))
            exps.append(
                f'<EXPERIMENT accession="SRX{gid:07d}" alias="e">\n'
                f"<TITLE>T {gid} &amp; things</TITLE>\n"
                f"<LIBRARY_STRATEGY>{random.choice(['WGS', 'RNA-Seq'])}"
                f"</LIBRARY_STRATEGY>\n</EXPERIMENT>")
            if i % 2 == 0:
                samps.append(
                    f'<SAMPLE accession="{samp.lower()}" alias="s">\n'
                    f"<SCIENTIFIC_NAME>Taxon {gid}</SCIENTIFIC_NAME>\n"
                    "<SAMPLE_ATTRIBUTE>\n<TAG>env</TAG>\n"
                    f"<VALUE>value {gid}</VALUE>\n</SAMPLE_ATTRIBUTE>\n"
                    "<SAMPLE_ATTRIBUTE>\n<TAG>Center</TAG>\n"
                    "<VALUE>override</VALUE>\n</SAMPLE_ATTRIBUTE>\n"
                    "</SAMPLE>")
        studies.append(
            f'<STUDY accession="SRP{trial:07d}" alias="p">\n'
            f"<STUDY_TITLE>Study {trial}</STUDY_TITLE>\n</STUDY>")
        path = tmp_path / f"fuzz{trial}.tar.gz"
        longdir = "a" * 90 + f"/deep{trial}"
        with tarfile.open(path, "w:gz") as tf:
            def add(name, text):
                b = text.encode()
                ti = tarfile.TarInfo(name)
                ti.size = len(b)
                tf.addfile(ti, io.BytesIO(b))
            add(f"{longdir}/SUB.experiment.xml",
                "<EXPERIMENT_SET>\n" + "\n".join(exps) + "\n</EXPERIMENT_SET>")
            add("SUB/SUB.sample.xml",
                "<SAMPLE_SET>\n" + "\n".join(samps) + "\n</SAMPLE_SET>")
            add("SUB/SUB.study.xml",
                "<STUDY_SET>\n" + "\n".join(studies) + "\n</STUDY_SET>")
            add("SRA_Accessions", "\n".join(rows) + "\n")
        a = tmp_path / f"na{trial}.bin"
        b = tmp_path / f"py{trial}.bin"
        na = build_inventory(str(path), str(a), verbose=False)
        monkeypatch.setattr(
            "kwage.native.build_inventory_native",
            lambda *args, **kw: None)
        try:
            nb = build_inventory(str(path), str(b), verbose=False)
        finally:
            monkeypatch.undo()
        assert na == nb and na > 0
        assert a.read_bytes() == b.read_bytes(), trial


def _tar_member_raw(name: str, data: bytes, size_mode: str = "octal") -> bytes:
    """One ustar member as raw bytes with the size field encoded as
    'octal', 'base256' (GNU binary, the >=8 GiB form) or 'pax' (zeroed
    octal field + a PAX 'x' header carrying the size= record)."""
    import tarfile as _t

    def header(nm, size_field: bytes, typeflag: bytes, size_for_pad: int):
        h = bytearray(512)
        h[0:len(nm)] = nm.encode()
        h[100:108] = b"0000644\x00"
        h[108:116] = b"0000000\x00"
        h[116:124] = b"0000000\x00"
        h[124:136] = size_field
        h[136:148] = b"00000000000\x00"
        h[148:156] = b" " * 8  # checksum placeholder
        h[156:157] = typeflag
        h[257:263] = b"ustar\x00"
        h[263:265] = b"00"
        chk = sum(h)
        h[148:156] = (f"{chk:06o}\x00 ").encode()
        return bytes(h)

    def padded(b: bytes) -> bytes:
        pad = (-len(b)) % 512
        return b + b"\x00" * pad

    if size_mode == "octal":
        sf = (f"{len(data):011o}\x00").encode()
        return header(name, sf, b"0", len(data)) + padded(data)
    if size_mode == "base256":
        sf = bytearray(12)
        sf[0] = 0x80
        v = len(data)
        for i in range(11, 0, -1):
            sf[i] = v & 0xFF
            v >>= 8
        return header(name, bytes(sf), b"0", len(data)) + padded(data)
    assert size_mode == "pax"
    rec = f"size={len(data)}\n"
    n = len(rec) + 3  # "LL " prefix, 2-digit assumption adjusted below
    while len(f"{n} {rec}") != n:
        n = len(f"{n} {rec}")
    pax = f"{n} {rec}".encode()
    sfz = b"00000000000\x00"  # zeroed octal: only the PAX record has it
    sfp = (f"{len(pax):011o}\x00").encode()
    return (header("PaxHeaders.0/" + name, sfp, b"x", len(pax)) + padded(pax)
            + header(name, sfz, b"0", len(data)) + padded(data))


@pytest.mark.parametrize("size_mode", ["base256", "pax"])
def test_native_inventory_large_size_encodings(tmp_path, monkeypatch, size_mode):
    """GNU base-256 and PAX size= member sizes (what tar writes past the
    8 GiB octal limit) parse identically to Python tarfile in the native
    tar reader -- byte-equal inventories from both paths."""
    from kwage.native import available

    if not available():
        pytest.skip("native library unavailable")
    header = "\t".join(
        ["Accession", "Submission", "Status", "Updated", "Published",
         "Received", "Type", "Center", "Visibility", "Alias", "Experiment",
         "Sample", "Study", "Loaded", "Spots", "Bases"])
    rows = [header]
    for i in range(1, 6):
        rows.append("\t".join(
            [f"SRR{i:07d}", "SUB1", "live", "2020-01-01", "2020-01-02",
             "2020-06-15T10:00:00Z", "RUN", "LANL", "public", "-",
             f"SRX{i:07d}", f"SRS{i:07d}", "SRP0000001", "1", str(i * 10),
             str(i * 1000)]))
    data = ("\n".join(rows) + "\n").encode()
    raw = _tar_member_raw("SRA_Accessions", data, size_mode) + b"\x00" * 1024
    path = tmp_path / f"{size_mode}.tar"
    path.write_bytes(raw)

    a = tmp_path / "native.bin"
    b = tmp_path / "python.bin"
    na = build_inventory(str(path), str(a), verbose=False)
    monkeypatch.setattr(
        "kwage.native.build_inventory_native", lambda *x, **k: None)
    nb = build_inventory(str(path), str(b), verbose=False)
    monkeypatch.undo()
    assert na == nb == 5
    assert a.read_bytes() == b.read_bytes()


def test_native_inventory_edge_semantics(metadata_tar, tmp_path, monkeypatch):
    """Parity of the edge cases: an empty-string filter set entry (not
    expressible on the native wire -> twin handles it), an EMPTY
    SRA_Accessions member (error on both paths), a second table member
    treated as data rows, and output-open failure naming the right path."""
    import io
    import tarfile

    from kwage.native import available

    if not available():
        pytest.skip("native library unavailable")

    # {""} as a filter must behave like the Python twin (everything
    # filtered out, since no record has an empty strategy).
    out = tmp_path / "empty_filter.bin"
    n = build_inventory(metadata_tar, str(out),
                        InventoryFilters(required_strategy={""}),
                        verbose=False)
    assert n == 0

    # Empty SRA_Accessions member: both paths raise.
    bad = tmp_path / "empty_member.tar.gz"
    with tarfile.open(bad, "w:gz") as tf:
        ti = tarfile.TarInfo("SRA_Accessions")
        ti.size = 0
        tf.addfile(ti, io.BytesIO(b""))
    with pytest.raises(ValueError):
        build_inventory(str(bad), str(tmp_path / "x.bin"), verbose=False)
    monkeypatch.setattr(
        "kwage.native.build_inventory_native", lambda *a, **k: None)
    with pytest.raises(ValueError):
        build_inventory(str(bad), str(tmp_path / "x2.bin"), verbose=False)
    monkeypatch.undo()

    # Two SRA_Accessions members: the second member's rows are DATA
    # (one global header), identical on both paths.
    header = "\t".join([
        "Accession", "Submission", "Status", "Updated", "Published", "Received",
        "Type", "Center", "Visibility", "Alias", "Experiment", "Sample", "Study",
        "Loaded", "Spots", "Bases"])
    row = lambda i: "\t".join(
        [f"SRR{i:07d}", "SUB1", "live", "2020-01-01", "2020-01-02",
         "2020-06-15T10:00:00Z", "RUN", "-", "public", "-", "-", "-", "-",
         "1", "1", str(i)])
    two = tmp_path / "two_members.tar.gz"
    with tarfile.open(two, "w:gz") as tf:
        for name, text in [("a/SRA_Accessions", header + "\n" + row(1) + "\n"),
                           ("b/SRA_Accessions", row(2) + "\n" + row(3) + "\n")]:
            b = text.encode()
            ti = tarfile.TarInfo(name)
            ti.size = len(b)
            tf.addfile(ti, io.BytesIO(b))
    a = tmp_path / "two_native.bin"
    c = tmp_path / "two_python.bin"
    na = build_inventory(str(two), str(a), verbose=False)
    monkeypatch.setattr(
        "kwage.native.build_inventory_native", lambda *x, **k: None)
    nc = build_inventory(str(two), str(c), verbose=False)
    monkeypatch.undo()
    assert na == nc == 3
    assert a.read_bytes() == c.read_bytes()

    # Output open failure: OSError naming the OUTPUT path.
    with pytest.raises(OSError, match="no/such"):
        build_inventory(metadata_tar, str(tmp_path / "no/such/dir/o.bin"),
                        verbose=False)


def test_search_all_native_rejects_bad_num_hash():
    """num_hash outside the reference's 1..5 range returns None (the
    caller falls back to the per-query twin) instead of reading
    uninitialized hash lanes."""
    import numpy as np

    from kwage.native import available, search_all_native

    if not available():
        pytest.skip("native library unavailable")
    slices = np.zeros((16, 2), dtype=np.uint8)
    assert search_all_native(slices, ["ACGTACGTACGTACGTACGTA"],
                             21, 6, 4, 10, 0.5) is None
    assert search_all_native(slices, ["ACGTACGTACGTACGTACGTA"],
                             21, 0, 4, 10, 0.5) is None


def test_archive_scale_inventory_bounded_rss(tmp_path):
    """Archive-scale miniature of tools/bench_inventory_archive.py: 120k
    run records (>100k XML records, so the native builder's overflow
    merge -- kwage_native.cpp kMaxNumXml, mirroring the reference
    MAX_NUM_XML, sra_inventory.cpp:736-775 -- actually fires) build
    correctly with bounded memory. RSS is asserted as a DELTA over an
    import-only probe child, so the interpreter's own baseline does not
    count. The bound is generous (records must be
    held for the global sort, ~1 KB each) but catches an unbounded
    annotation map, which would hold every XML string at once."""
    import subprocess
    import sys

    from kwage.native import available

    if not available():
        pytest.skip("native library unavailable")
    script = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tools", "bench_inventory_archive.py")
    env = dict(os.environ)
    env.update(INV_N_RECORDS="120000", INV_SUB_SIZE="1000",
               INV_SKIP_ORACLE="1")
    proc = subprocess.run(
        [sys.executable, script, str(tmp_path / "work")], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    phases = {json.loads(l)["phase"]: json.loads(l)
              for l in proc.stdout.splitlines() if l.startswith("{")}
    nb = phases["native_build"]
    # every i % 11 == 0 row (i=0 included) is "suppressed" and dropped
    assert nb["n_written"] == 120000 - (120000 // 11 + 1)
    # 120k records at ~1 KB apiece for the sort plus the <=100k-entry
    # annotation window: anything past 600 MB means the overflow merge
    # is not bounding the map.
    assert nb["delta_rss_mb"] < 600, nb
    assert phases["done"]["ok"] is True
