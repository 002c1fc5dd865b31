"""One-command libncbi-vdb validation for any machine with the real
library (VERDICT r04 task 5).

Reports, as one JSON object on stdout:
  - which library file was found ($KWAGE_VDB_LIB or find_library) and
    whether the REQUIRED cursor surface binds (``available``);
  - whether the KMetadata surface binds (``meta_available``; older
    releases predate it -- the engine falls back to sra-stat);
  - the KPathType pin values in effect (override with
    $KWAGE_VDB_KPT_DATABASE / _TABLE / _PRERELEASE on old releases);
  - with an accession argument: the resolved path type, the first
    fragments streamed through real VDB cursors, and the STATS/TABLE
    BASE_COUNT/SPOT_COUNT metadata read.

Usage:
  python tools/vdb_smoke.py                    # bind check only
  python tools/vdb_smoke.py SRR000001          # + stream + metadata
  python tools/vdb_smoke.py --max-frags 12 SRR000001

Exit 0 = everything attempted worked; 1 = something failed (the JSON
says what). Reference call sequence: sra_stream.cpp:90-413,
sra_meta.cpp:17-122.
"""

from __future__ import annotations

import json
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    max_frags = 8
    if "--max-frags" in args:
        i = args.index("--max-frags")
        max_frags = int(args[i + 1])
        del args[i:i + 2]
    accession = args[0] if args else None

    from kwage.sriracha import vdb

    report: dict = {
        "library": vdb._find_lib_path(),
        "available": vdb.available(),
        "meta_available": vdb.meta_available(),
        "kpt_pins": {
            "KPT_DATABASE": vdb.KPT_DATABASE,
            "KPT_TABLE": vdb.KPT_TABLE,
            "KPT_PRERELEASE_TBL": vdb.KPT_PRERELEASE_TBL,
        },
    }
    ok = report["available"]
    if not ok:
        report["hint"] = (
            "no loadable libncbi-vdb with the full cursor surface; set "
            "KWAGE_VDB_LIB=/path/to/libncbi-vdb.so (symbol-subset builds "
            "are rejected at bind time)")
    elif accession:
        from kwage.sriracha.sra_source import DownloadError

        lib = vdb._load()
        mgr = vdb._open_manager(lib)
        try:
            ptype = vdb._resolve_path_type(lib, mgr, accession.encode())
        finally:
            lib.VDBManagerRelease(mgr)
        report["accession"] = accession
        report["path_type"] = ptype
        report["path_type_known"] = ptype in (
            vdb.KPT_DATABASE, vdb.KPT_TABLE, vdb.KPT_PRERELEASE_TBL)
        if not report["path_type_known"]:
            report["hint"] = (
                f"path type {ptype} matches no pin -- on older releases "
                "set KWAGE_VDB_KPT_DATABASE/_TABLE/_PRERELEASE")
        try:
            frags = []
            for row, sub, seq in vdb.stream_accession_vdb(accession):
                frags.append({"row": row, "sub": sub, "len": len(seq),
                              "head": seq[:16]})
                if len(frags) >= max_frags:
                    break
            report["streamed_fragments"] = frags
            report["stream_ok"] = bool(frags)
        except DownloadError as e:
            report["stream_ok"] = False
            report["stream_error"] = f"status {e.status}: {e}"
        ok = ok and report.get("stream_ok", False)
        if report["meta_available"]:
            try:
                bases, spots = vdb.vdb_number_of_bases(accession)
                report["metadata"] = {"BASE_COUNT": bases,
                                      "SPOT_COUNT": spots}
            except DownloadError as e:
                report["metadata_error"] = f"status {e.status}: {e}"
                ok = False

    print(json.dumps(report, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
