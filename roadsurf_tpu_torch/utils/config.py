"""The pipeline's YAML configs: one file per workflow, one block per
consumer script, keyed by the script's file name (a copy of the reference
package's ``utils/config.py``), so the same config files drive the port."""

from __future__ import annotations

import os
from typing import Any

import yaml


def load_config(path: str) -> dict[str, Any]:
    """Load a whole YAML config file."""
    with open(path) as fp:
        return yaml.safe_load(fp)


def load_script_config(path: str, script_name: str) -> dict[str, Any]:
    """Load the block of a YAML config keyed by the consumer script name
    (a bare name such as "make_detections.py", or a path: its basename is
    used)."""
    key = os.path.basename(script_name)
    cfg = load_config(path)
    if key not in cfg:
        raise KeyError(
            f"config file {path!r} has no block for script {key!r}; "
            f"available blocks: {sorted(cfg)}"
        )
    return cfg[key]
