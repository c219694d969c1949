"""The training cells' data: a synthetic BreaDM tree (harness/synthetic)
packed by the port's pack writer (data/pack.write_pack, the path
`cli/pack` runs), made once per checkout from the traffic's fixed data
seed into build/portbench/data-<hash of the traffic's dataset>/ and
reused by every later run there, as the kernels' build is."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from pathlib import Path
from typing import Tuple

from portbench.harness import synthetic


def ensure_pack(root: Path, ds: dict, seq_types) -> Tuple[Path, Path]:
    """(tree root, pack root) of the traffic's `dataset` section."""
    from stf_unet_tpu_torch.data.index import DatasetIndex
    from stf_unet_tpu_torch.data.pack import write_pack

    key = hashlib.sha256(json.dumps(ds, sort_keys=True).encode()).hexdigest()
    base = Path(root) / "build" / "portbench" / f"data-{key[:16]}"
    if (base / "READY").exists():
        return base / "tree", base / "pack"
    print(f"making the training pack in {base}", file=sys.stderr)
    stage = base.with_name(base.name + ".partial")
    shutil.rmtree(stage, ignore_errors=True)
    synthetic.write_tree(str(stage / "tree"), ds["data_seed"],
                         ds["patients"], ds["slices_per_patient"],
                         ds["size"], ds["time_steps"])
    index = DatasetIndex(str(stage / "tree"), "train", seq_types)
    write_pack(index, str(stage / "pack" / "train"), use_native=False)
    shutil.rmtree(base, ignore_errors=True)
    os.replace(stage, base)
    (base / "READY").write_text("ok\n")
    return base / "tree", base / "pack"
