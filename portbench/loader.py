"""Files found by name: a cell's configuration, its traffic file and each
metric name the modules and data under `portbench/` that they use, one
folder a kind:

    metrics/<name>.py     a metric's reader
    entries/<name>.py     a configuration's entry (how the program is driven)
    reference/<name>.py   a configuration's plain reference
    reference/<name>.json a rules file in the reference's JSON form
    shapes/<name>.py      a traffic file's tree shape
"""

import importlib.util
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def load(kind: str, name: str, bench: Path = BENCH):
    """The module `portbench/<kind>/<name>.py`."""
    path = bench / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    if spec is None or not path.exists():
        raise SystemExit(f"no {kind} module {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rules_file(name: str, bench: Path = BENCH) -> Path:
    """The rules file `portbench/reference/<name>.json`."""
    path = bench / "reference" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no rules file {name!r} at {path}")
    return path
