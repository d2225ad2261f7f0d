"""CSV metrics logger with evolving fields (copy of
bflow_tpu/loggers/csv_logger.py): a row with a new key rewrites the file
under the wider header."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Optional


class CSVLogger:
    def __init__(self, out_dir: str, name: str = "metrics"):
        self.path = Path(out_dir)
        self.path.mkdir(parents=True, exist_ok=True)
        self.file = self.path / f"{name}.csv"
        self._fieldnames: Optional[list] = None
        self._fh = None
        self._writer = None

    def log(self, metrics: Dict[str, float], step: int) -> None:
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if self._writer is None or any(
            k not in self._fieldnames for k in row
        ):
            old_rows = []
            if self._fh is not None:
                self._fh.close()
                with open(self.file) as fh:
                    old_rows = list(csv.DictReader(fh))
            self._fieldnames = sorted(
                set(row) | {k for r in old_rows for k in r}
            )
            self._fh = open(self.file, "w", newline="")
            self._writer = csv.DictWriter(self._fh, self._fieldnames)
            self._writer.writeheader()
            for r in old_rows:
                self._writer.writerow(r)
        self._writer.writerow(row)
        self._fh.flush()

    def finalize(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
            self._writer = None
