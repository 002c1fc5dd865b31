"""Where the tools write their records: results/<name> in the checkout
(listed in .gitignore), one JSON document per tool run."""

from __future__ import annotations

import json
import os

RESULTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "results")


def write_results(name: str, records) -> str:
    """Write ``records`` as indented JSON to results/<name>; returns the path."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, name)
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    return path
