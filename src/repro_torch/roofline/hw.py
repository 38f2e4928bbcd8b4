"""NVIDIA H100 SXM (80 GB HBM3) constants: the card's published, spec-sheet
peaks for dense work, per card.  The roofline (`roofline/analysis.py`,
`roofline/components.py`) and `chip_smoke.py`'s kernel bounds read them
from here.  A card whose power limit is set below 700 W runs below these
peaks under load; the peaks themselves do not change.  Byte sizes come
from `Tensor.element_size()`, so there is no table of them here."""

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12  # FLOP/s, fp32 on the CUDA cores
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80e9  # 80 GB
NVLINK_BW = 450e9  # bytes/s per direction across the card's links (unused on a mesh of one)
