"""BreaDM dataset index scanner (ref:my_dataset.py:15-141).

Scans `<root>/seg/{training,val,test}/images/<patient>/<SEQ>/<slice>.{jpg,png}`
plus `labels/<patient>/<SEQ1>/<slice>.png`, with the reference's
warn-and-skip fault tolerance:
  * a patient missing any required sequence directory is skipped (ref:69-77),
  * a slice missing in any sequence is skipped (ref:96-108),
  * a slice with no mask next to the FIRST sequence is skipped (ref:110-126),
  * with PK maps enabled, patients without `pk_maps/<patient>/` are skipped
    (ref:79-89).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

MODE_DIRS = {"train": "training", "val": "val", "test": "test"}  # ref:22-26
IMG_EXTS = (".jpg", ".png")


@dataclass(frozen=True)
class SampleRecord:
    patient_id: str
    image_paths: Sequence[str]  # one per sequence/time step
    mask_path: str
    pk_maps_path: Optional[str] = None


@dataclass
class DatasetIndex:
    root: str
    mode: str
    sequence_types: Sequence[str]
    use_pk_maps: bool = False
    records: List[SampleRecord] = field(default_factory=list)

    def __post_init__(self):
        if self.mode not in MODE_DIRS:
            raise ValueError(f"Unsupported mode: {self.mode}")
        data_root = os.path.join(self.root, "seg", MODE_DIRS[self.mode])
        img_dir = os.path.join(data_root, "images")
        mask_dir = os.path.join(data_root, "labels")
        for p in (data_root, img_dir, mask_dir):
            if not os.path.exists(p):
                raise FileNotFoundError(f"path '{p}' does not exist.")

        for patient in sorted(os.listdir(img_dir)):
            patient_img = os.path.join(img_dir, patient)
            patient_mask = os.path.join(mask_dir, patient)
            if not (os.path.isdir(patient_img) and os.path.isdir(patient_mask)):
                continue

            missing_seq = [s for s in self.sequence_types
                           if not os.path.exists(os.path.join(patient_img, s))]
            if missing_seq:
                print(f"Warning: Sequence {missing_seq[0]} not found for "
                      f"patient {patient}")
                continue

            pk_path = None
            if self.use_pk_maps:
                pk_path = os.path.join(data_root, "pk_maps", patient)
                if not os.path.exists(pk_path):
                    print(f"Warning: PK maps not found for patient {patient}")
                    continue

            first_seq = os.path.join(patient_img, self.sequence_types[0])
            for img_file in sorted(os.listdir(first_seq)):
                if not img_file.endswith(IMG_EXTS):
                    continue
                seq_paths = []
                complete = True
                for seq in self.sequence_types:
                    path = os.path.join(patient_img, seq, img_file)
                    if not os.path.exists(path):
                        complete = False
                        break
                    seq_paths.append(path)
                if not complete:
                    continue

                base = os.path.splitext(img_file)[0]
                mask_path = None
                for ext in (".png", ".jpg"):  # ref:112
                    cand = os.path.join(patient_mask, self.sequence_types[0],
                                        base + ext)
                    if os.path.exists(cand):
                        mask_path = cand
                        break
                if mask_path is None:
                    print(f"Warning: No mask found for image {img_file} of "
                          f"patient {patient}")
                    continue

                self.records.append(SampleRecord(
                    patient_id=patient,
                    image_paths=tuple(seq_paths),
                    mask_path=mask_path,
                    pk_maps_path=pk_path,
                ))

        if not self.records:
            print(f"Error: No valid image-mask pairs found in {data_root}")
            print(f"Checked sequence types: {list(self.sequence_types)}")
        else:
            print(f"Found {len(self.records)} image-mask pairs for "
                  f"{MODE_DIRS[self.mode]} set")

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> SampleRecord:
        return self.records[i]
