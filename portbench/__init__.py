"""The benchmark of ``roadsurf_tpu_torch``: ``TileInferenceEngine`` driven
from host tiles, cell by cell, with a plain float32 reference that decides
``correct``. ``python -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; see README.md."""
