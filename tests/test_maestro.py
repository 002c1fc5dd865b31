"""Maestro scheduler: end-to-end database construction, checkpoint/restart,
retry accounting, and byte parity of the produced databases."""

import hashlib
import json
import os

import numpy as np
import pytest

from kwage.io.status import read_status_file
from kwage.io.inventory import write_inventory
from kwage.core import FilterInfo, str_to_accession
from kwage.parallel.maestro import (
    LocalFastaResolver,
    Maestro,
    MaestroOptions,
    STATUS_BLOOM_FAIL_1,
    STATUS_DATABASE_SUCCESS,
    STATUS_DOWNLOAD_FAIL,
    STATUS_SKIPPED,
)


@pytest.fixture(scope="module")
def manifest(golden_dir):
    with open(golden_dir / "e2e" / "manifest.json") as f:
        return json.load(f)


def _options(manifest, work, **kw):
    opt = MaestroOptions(
        metadata_file=str(work / "inventory.bin"),
        scratch_bloom_dir=str(work / "bloom"),
        scratch_database_dir=str(work / "db"),
        status_file=str(work / "status.bin"),
        kmer_len=manifest["k"],
        min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"],
        min_log_2_filter_len=manifest["minL"],
        max_log_2_filter_len=manifest["maxL"],
        min_log_2_count_len=manifest["minLc"],
        max_log_2_count_len=manifest["maxLc"],
        num_workers=2,
        save_bloom=True,
    )
    for k, v in kw.items():
        setattr(opt, k, v)
    return opt


def _write_inventory(manifest, work, accessions=None):
    accs = accessions if accessions is not None else manifest["accessions"]
    infos = [FilterInfo(run_accession=str_to_accession(a)) for a in accs]
    write_inventory(str(work / "inventory.bin"), infos)
    return infos


def _sha(p):
    with open(p, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_full_run_produces_reference_databases(manifest, data_dir, golden_dir, tmp_path):
    """A complete maestro run reproduces the golden .db files byte-for-byte."""
    _write_inventory(manifest, tmp_path)
    opt = _options(manifest, tmp_path)
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()

    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    with open(golden_dir / "e2e" / "digests.json") as f:
        digests = json.load(f)
    # Database files count from 1 (maestro_main.cpp:180); golden digest
    # keys are indexed by group position.
    for gi in range(len(manifest["db_groups"])):
        got = _sha(tmp_path / "db" / f"sra.{gi + 1}.db")
        assert got == digests[f"sra.{gi}.db"], f"group {gi} differs"

    # The status checkpoint reflects the final state + database index.
    status, db_index = read_status_file(opt.status_file, len(manifest["accessions"]))
    assert db_index == len(manifest["db_groups"]) + 1
    assert (status == STATUS_DATABASE_SUCCESS).all()


def test_device_build_produces_reference_databases(manifest, data_dir, golden_dir, tmp_path):
    """The device ingest path (exact-count thresholding on device) reproduces
    the golden reference databases byte-for-byte on this corpus: the
    counting filter is collision-free here, so the reference's
    approximation and the exact count agree."""
    _write_inventory(manifest, tmp_path)
    opt = _options(manifest, tmp_path, device_build=True)
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()

    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    with open(golden_dir / "e2e" / "digests.json") as f:
        digests = json.load(f)
    for gi in range(len(manifest["db_groups"])):
        got = _sha(tmp_path / "db" / f"sra.{gi + 1}.db")
        assert got == digests[f"sra.{gi}.db"], f"group {gi} differs"


def _db_accessions(db_dir):
    """Set of run accessions across every .db file in a directory."""
    from kwage.io.dbz_file import open_database
    from kwage.core import accession_to_str

    accs = set()
    for f in os.listdir(db_dir):
        if f.endswith(".db"):
            db = open_database(os.path.join(db_dir, f))
            for info in db.read_all_filter_info():
                accs.add(accession_to_str(info.run_accession))
    return accs


def test_restart_resumes_and_completes(manifest, data_dir, tmp_path):
    """--halt-after caps the fresh-work cursor (maestro_main.cpp:285-317)
    and the forced flush packs what it has into partial database files; a
    fresh Maestro then resumes from the checkpoint and converges with
    every accession committed to a database."""
    _write_inventory(manifest, tmp_path)
    opt = _options(manifest, tmp_path, limit_num_download=3)
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()
    # Only the first 3 accessions progressed, and the forced flush packed
    # them into (partial) database files, like the reference.
    assert sum(1 for s in m.status if s != 1) == 3
    assert sum(1 for s in m.status if s == STATUS_DATABASE_SUCCESS) == 3

    opt2 = _options(manifest, tmp_path)
    m2 = Maestro(opt2, LocalFastaResolver(str(data_dir)))
    m2.restore()
    m2.run()
    assert all(s == STATUS_DATABASE_SUCCESS for s in m2.status), m2.summary()
    # Groupings differ from a single uninterrupted run (partial files were
    # flushed before the restart), but every accession must be committed
    # exactly once across the full set of database files.
    assert _db_accessions(tmp_path / "db") == set(manifest["accessions"])


def test_missing_accession_fails_after_retries(manifest, data_dir, tmp_path):
    accs = manifest["accessions"][:2] + ["SRR9999999"]
    _write_inventory(manifest, tmp_path, accs)
    opt = _options(manifest, tmp_path, num_download_attempt=2)
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()
    assert m.status[2] == STATUS_DOWNLOAD_FAIL
    assert m.status[0] == STATUS_DATABASE_SUCCESS
    assert m.status[1] == STATUS_DATABASE_SUCCESS


def test_skip_marking(manifest, data_dir, tmp_path):
    accs = manifest["accessions"][:3]
    _write_inventory(manifest, tmp_path, accs)
    opt = _options(manifest, tmp_path, skip_sra=[accs[1]])
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    assert m.status[1] == STATUS_SKIPPED
    m.run()
    assert m.status[1] == STATUS_SKIPPED
    assert m.status[0] == STATUS_DATABASE_SUCCESS


def test_rollback_of_incomplete_bloom(manifest, data_dir, tmp_path):
    """A .bloom with the in-progress magic byte is rolled back to INIT on
    restore (maestro_main.cpp:699-802)."""
    accs = manifest["accessions"][:2]
    _write_inventory(manifest, tmp_path, accs)
    opt = _options(manifest, tmp_path)
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()

    # Corrupt one bloom (mark in-progress) and claim BLOOM_SUCCESS state.
    from kwage.io.status import write_status_file
    import numpy as np

    bloom = m.bloom_path(0)
    data = bytearray(open(bloom, "rb").read())
    data[0] = 0x00
    open(bloom, "wb").write(bytes(data))
    status = np.array([14, 14], dtype=np.uint8)  # both claim BLOOM_SUCCESS
    write_status_file(opt.status_file, status, 0)

    m2 = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m2.restore()
    assert m2.status[0] == 1  # rolled back to INIT
    assert m2.status[1] == 14


def test_streaming_resolver_without_toolkit(manifest, tmp_path):
    """--stream mode: accessions resolve via fasterq-dump; with no SRA
    toolkit installed every download fails cleanly after the retry budget."""
    from kwage.parallel.maestro import StreamingResolver

    accs = manifest["accessions"][:2]
    _write_inventory(manifest, tmp_path, accessions=accs)
    opt = _options(manifest, tmp_path, num_download_attempt=1)
    m = Maestro(opt, StreamingResolver(str(tmp_path / "stream")))
    m.restore()
    m.run()
    assert all(s == STATUS_DOWNLOAD_FAIL for s in m.status), m.summary()


def test_flaky_resolver_recovers_via_retries(manifest, data_dir, tmp_path):
    """Fault injection: a resolver that fails each accession's first two
    attempts must still converge through the retry state machine
    (maestro_main.cpp retry queues)."""

    class FlakyResolver(LocalFastaResolver):
        def __init__(self, source_dir):
            super().__init__(source_dir)
            self.attempts = {}

        def resolve(self, accession):
            n = self.attempts.get(accession, 0)
            self.attempts[accession] = n + 1
            if n < 2:
                return None  # simulated download failure
            return super().resolve(accession)

    accs = manifest["accessions"][:4]
    _write_inventory(manifest, tmp_path, accessions=accs)
    opt = _options(manifest, tmp_path, num_download_attempt=3, num_workers=2)
    m = Maestro(opt, FlakyResolver(str(data_dir)))
    m.restore()
    m.run()
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()

    # With a retry budget below the failure count, accessions fail hard.
    tmp2 = tmp_path / "b"
    tmp2.mkdir()
    _write_inventory(manifest, tmp2, accessions=accs)
    opt2 = _options(manifest, tmp2, num_download_attempt=2, num_workers=2)
    m2 = Maestro(opt2, FlakyResolver(str(data_dir)))
    m2.restore()
    m2.run()
    assert all(s == STATUS_DOWNLOAD_FAIL for s in m2.status), m2.summary()


def test_full_vocabulary_status_restore(manifest, data_dir, tmp_path):
    """Resume interop: a status file containing EVERY reference state value
    (maestro.h:8-45) drives to all-terminal with the reference's restore
    semantics (maestro_main.cpp:200-240, 618-802):

    - DOWNLOAD_SUCCESS with a staged source -> Bloom creation; without -> INIT
    - DOWNLOAD_FAIL_n -> retried iff n < --retry, else left as-is
    - BLOOM_FAIL (final) and BLOOM_FAIL_1..10 -> re-downloaded in download mode
    - BLOOM_SUCCESS / DATABASE_FAIL with a valid .bloom -> re-packed;
      without -> INIT and rebuilt
    - DATABASE_UPLOAD_FAIL -> never recovered (manual_db territory)
    - DOWNLOAD_FAIL, BLOOM_INVALID, DATABASE_SUCCESS, SKIPPED -> terminal
    """
    from kwage.io.status import write_status_file
    from kwage.pipeline.make_bloom import build_bloom_from_file
    from kwage.io.bloom_file import write_bloom_file

    real = manifest["accessions"]  # SRR1000000..9 have local sources
    missing = [f"SRR{3000000 + i}" for i in range(30)]
    mi = iter(missing)
    # (accession, initial state) covering all 30 reference values + one
    # extra DOWNLOAD_SUCCESS-without-source case.
    plan = [
        (real[0], 1),        # INIT
        (real[1], 2),        # DOWNLOAD_SUCCESS, source staged
        (next(mi), 3),       # DOWNLOAD_FAIL (terminal)
        (real[2], 4),        # DOWNLOAD_FAIL_1 -> retried
        (real[3], 5),        # DOWNLOAD_FAIL_2 -> retried
        (next(mi), 6),       # DOWNLOAD_FAIL_3 -> exhausted (retry=3)
        (next(mi), 7), (next(mi), 8), (next(mi), 9), (next(mi), 10),
        (next(mi), 11), (next(mi), 12), (next(mi), 13),  # DF_4..DF_10 exhausted
        (real[4], 14),       # BLOOM_SUCCESS, valid .bloom staged -> re-packed
        (real[5], 15),       # BLOOM_FAIL (final) -> re-downloaded in download mode
        (next(mi), 16),      # BLOOM_INVALID (terminal)
        (next(mi), 17),      # DATABASE_SUCCESS (terminal)
        (real[6], 18),       # DATABASE_FAIL, valid .bloom staged -> re-packed
        (real[7], 19),       # DATABASE_UPLOAD_FAIL -> NOT recovered
        (real[8], 20),       # BLOOM_FAIL_1 -> re-downloaded
        (real[9], 21),       # BLOOM_FAIL_2 -> re-downloaded
        (next(mi), 22), (next(mi), 23), (next(mi), 24), (next(mi), 25),
        (next(mi), 26), (next(mi), 27), (next(mi), 28), (next(mi), 29),
        (next(mi), 30),      # SKIPPED (terminal)
        (next(mi), 2),       # DOWNLOAD_SUCCESS without a source -> INIT -> dl-fail
    ]
    accs = [a for a, _ in plan]
    _write_inventory(manifest, tmp_path, accs)
    opt = _options(manifest, tmp_path, num_download_attempt=3)
    write_status_file(opt.status_file,
                      np.array([s for _, s in plan], dtype=np.uint8), 7)

    # Stage valid complete .bloom files for the BLOOM_SUCCESS and
    # DATABASE_FAIL entries (restore_bloom recovers both).
    os.makedirs(tmp_path / "bloom", exist_ok=True)
    for acc in (real[4], real[6]):
        rec = build_bloom_from_file(
            str(data_dir / f"{acc}.fasta"), opt.build_options(),
            FilterInfo(run_accession=str_to_accession(acc)))
        write_bloom_file(str(tmp_path / "bloom" / f"{acc}.bloom"), rec)

    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    assert m.database_index == 7
    m.run()

    S = [int(s) for s in m.status]
    D = STATUS_DATABASE_SUCCESS
    expect = [D, D, 3, D, D, 6, 7, 8, 9, 10, 11, 12, 13,
              D, D, 16, 17, D, 19, D, D,
              3, 3, 3, 3, 3, 3, 3, 3,  # BF_3..BF_10, no source -> dl-fail
              30, 3]
    assert S == expect, list(zip(accs, S, expect))

    # Every surviving state is terminal from the reference's perspective:
    # rerunning restore+run changes nothing.
    m2 = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m2.restore()
    m2.run()
    assert [int(s) for s in m2.status] == expect


def test_streaming_mode_state_machine(manifest, data_dir, tmp_path):
    """--stream mode: restored DOWNLOAD_SUCCESS and DOWNLOAD_FAIL_n states
    are re-streamed (maestro_main.cpp:1386-1400), and every failure is
    bloom-classed (the streaming worker replies STATUS_BLOOM_FAIL even for
    download errors)."""
    from kwage.io.status import write_status_file
    from kwage.parallel.maestro import STATUS_BLOOM_FAIL

    real = manifest["accessions"][:4]
    accs = real + ["SRR4000000", "SRR4000001"]
    _write_inventory(manifest, tmp_path, accs)
    opt = _options(manifest, tmp_path, stream_sra=True, num_download_attempt=2)
    # real: INIT, DOWNLOAD_SUCCESS, DOWNLOAD_FAIL_2, BLOOM_FAIL_1;
    # missing: INIT, BLOOM_FAIL (final -> terminal in streaming mode)
    write_status_file(opt.status_file,
                      np.array([1, 2, 5, 20, 1, 15], dtype=np.uint8), 1)
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()
    S = [int(s) for s in m.status]
    D = STATUS_DATABASE_SUCCESS
    assert S == [D, D, D, D, STATUS_BLOOM_FAIL, 15], S


def test_lazy_inventory_produces_reference_databases(manifest, data_dir, golden_dir, tmp_path):
    """lazy_inventory mode (accession/offset index + on-demand FilterInfo
    loads, the reference's parse_accession_loc memory profile) produces
    the same golden databases."""
    _write_inventory(manifest, tmp_path)
    opt = _options(manifest, tmp_path, lazy_inventory=True)
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    with open(golden_dir / "e2e" / "digests.json") as f:
        digests = json.load(f)
    for gi in range(len(manifest["db_groups"])):
        assert _sha(tmp_path / "db" / f"sra.{gi + 1}.db") == digests[f"sra.{gi}.db"]


def test_event_loop_opens_no_bloom_headers(manifest, data_dir, tmp_path, monkeypatch):
    """The scheduler's packing decisions are event-driven (the in-memory
    BloomParam group map, maestro_main.cpp:87-106 analog): a full run
    opens ZERO .bloom headers from the event loop -- header reads happen
    only in restore(). Guards against the O(pending) rescan-per-round
    regression."""
    import kwage.parallel.maestro as maestro_mod

    _write_inventory(manifest, tmp_path)
    opt = _options(manifest, tmp_path)
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()  # fresh job: nothing to rescan

    calls = {"n": 0}
    real = maestro_mod.read_bloom_file

    def counting(path, with_bits=True):
        calls["n"] += 1
        return real(path, with_bits)

    monkeypatch.setattr(maestro_mod, "read_bloom_file", counting)
    m.run()
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    assert calls["n"] == 0, f"event loop opened {calls['n']} .bloom headers"

    # And a restart rescans exactly once per recovered accession, not per
    # scheduling round.
    m2 = Maestro(opt, LocalFastaResolver(str(data_dir)))
    calls["n"] = 0
    m2.restore()
    n_restore = calls["n"]
    m2.run()
    assert calls["n"] == n_restore, "event loop reopened headers after restore"


def test_duplicate_bloom_event_absorbed_once(manifest, data_dir, tmp_path):
    """With --task-timeout a re-dispatched task can complete TWICE (both
    workers alive, distinct eids). The event-driven group map must absorb
    the completion once: no duplicate member in the packing group, no
    double-counted totals."""
    from kwage.core.params import BloomParam
    from kwage.parallel.maestro import STATUS_BLOOM_SUCCESS

    accs = manifest["accessions"][:2]
    infos = [FilterInfo(run_accession=str_to_accession(a),
                        number_of_bases=500)
             for a in accs]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path)
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()

    param = BloomParam(kmer_len=opt.kmer_len, log_2_filter_len=12, num_hash=3)
    m._absorb_bloom_event(0, STATUS_BLOOM_SUCCESS, param, 0.1)
    m._absorb_bloom_event(0, STATUS_BLOOM_SUCCESS, param, 0.1)  # duplicate
    assert m._groups[param] == [0]
    assert m._total_bp == 500

    # Still absorbed once if the duplicate lands AFTER the group packed
    # (members popped + pre-marked): the filter must not resurrect into a
    # second database.
    groups = m._take_ready_groups()
    m._forced_flush = True
    groups += m._take_ready_groups()
    assert sum(len(g[1]) for g in groups) == 1
    m._absorb_bloom_event(0, STATUS_BLOOM_SUCCESS, param, 0.1)
    assert m._groups.get(param, []) == []
    assert m._total_bp == 500


def test_static_slice_split(manifest, data_dir, tmp_path):
    """--slice/--of engine extension: two sliced schedulers over the same
    inventory produce, between them, exactly the unsliced run's filters
    (byte-identical .bloom files), touch only their own shard, and write
    non-colliding interleaved sra.<index>.db names."""
    # Unsliced reference run.
    full = tmp_path / "full"
    full.mkdir()
    _write_inventory(manifest, full)
    m = Maestro(_options(manifest, full), LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()
    want = {
        f: _sha(full / "bloom" / f) for f in os.listdir(full / "bloom")
    }
    assert len(want) == 10

    shard_blooms = {}
    db_names = []
    for s in range(2):
        w = tmp_path / f"s{s}"
        w.mkdir()
        _write_inventory(manifest, w)
        opt = _options(manifest, w, slice_index=s, num_slice=2)
        ms = Maestro(opt, LocalFastaResolver(str(data_dir)))
        ms.restore()
        ms.run()
        # Own shard terminal-success; other shard terminal-skipped.
        lo, hi = (0, 5) if s == 0 else (5, 10)
        assert all(st == STATUS_DATABASE_SUCCESS for st in ms.status[lo:hi])
        out = np.concatenate([ms.status[:lo], ms.status[hi:]])
        assert all(st == STATUS_SKIPPED for st in out)
        for f in os.listdir(w / "bloom"):
            assert f not in shard_blooms, "shards overlapped"
            shard_blooms[f] = _sha(w / "bloom" / f)
        db_names.append(set(os.listdir(w / "db")))
        # Interleaved numbering: shard s uses indices s+1, s+3, ...
        for name in db_names[-1]:
            idx = int(name.split(".")[1])
            assert idx % 2 == (s + 1) % 2

    assert shard_blooms == want
    assert not (db_names[0] & db_names[1])


def test_stale_failure_after_success_is_ignored(manifest, data_dir, tmp_path):
    """A FAILURE event arriving after a success was absorbed (a
    --task-timeout re-dispatch raced a slow worker, or a buffered remote
    event landed late) must not overwrite the completed status or queue a
    spurious rebuild -- the built filter stands."""
    from kwage.core.params import BloomParam
    from kwage.parallel.maestro import (
        STATUS_BLOOM_FAIL,
        STATUS_BLOOM_INVALID,
        STATUS_BLOOM_SUCCESS,
        STATUS_DOWNLOAD_FAIL,
    )

    _write_inventory(manifest, tmp_path)
    opt = _options(manifest, tmp_path)
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    param = BloomParam(kmer_len=manifest["k"], log_2_filter_len=12, num_hash=2)

    m._absorb_bloom_event(0, STATUS_BLOOM_SUCCESS, param, 0.1)
    assert int(m.status[0]) == STATUS_BLOOM_SUCCESS
    before_groups = {p: list(v) for p, v in m._groups.items()}

    for stale in (STATUS_BLOOM_FAIL, STATUS_BLOOM_INVALID,
                  STATUS_DOWNLOAD_FAIL):
        m._absorb_bloom_event(0, stale, None, 0.1)
        assert int(m.status[0]) == STATUS_BLOOM_SUCCESS, stale
    assert not m._retry
    assert {p: list(v) for p, v in m._groups.items()} == before_groups

    # And a failure for an accession with NO absorbed success still
    # applies normally.
    m._absorb_bloom_event(1, STATUS_BLOOM_FAIL, None, 0.1)
    assert int(m.status[1]) != STATUS_BLOOM_SUCCESS
