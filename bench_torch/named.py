"""Files of the benchmark found by name: a mix's kind of call
(``kinds/<kind>.py``), a configuration's static kernel
(``static_kernels/<name>.py``) and a metric's reader
(``metrics/<metric>.py``). A later change adds one by adding its file."""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def load(folder: Path, name: str, what: str):
    """The module ``folder/<name>.py``; a name with no such file is
    refused, with the names the folder has."""
    path = Path(folder) / f"{name}.py"
    if not path.is_file():
        have = sorted(p.stem for p in Path(folder).glob("*.py"))
        raise ValueError(f"unknown {what} {name!r}; the benchmark has {have}")
    tag = re.sub(r"\W", "_", f"{Path(folder).name}_{name}")
    spec = importlib.util.spec_from_file_location(f"bench_torch_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
