"""The NVIDIA H100 SXM's constants for the roofline model — the port of
``repro.launch.hw``, which holds the TPU v5e's, under the reference's
names. Per card, dense rates, at the card's full 700 W power limit (NVIDIA
data sheet; the ``hopper-kernels`` table in PERF.md):

  * ``PEAK_FLOPS_BF16`` — bf16 on the tensor cores, dense;
  * ``PEAK_FLOPS_FP32`` — float32 outside the tensor cores, the rate of
    the port's fp32 training and serving (TF32 off);
  * ``HBM_BW`` — HBM3 bytes per second;
  * ``ICI_BW`` — the card's NVLink bandwidth each way (900 GB/s to the
    other cards of its host, all to all): Hopper has no ICI, the name is
    the reference's;
  * ``CHIP_HBM_BYTES`` — device memory;
  * ``VMEM_BYTES`` — the shared memory one block may opt in to (227 KB of
    the SM's 256 KB): Hopper has no VMEM, the name is the reference's.
"""

PEAK_FLOPS_BF16 = 989.4e12    # FLOP/s per card
PEAK_FLOPS_FP32 = 67e12       # FLOP/s per card
HBM_BW = 3.35e12              # B/s per card
ICI_BW = 450e9                # B/s per card, each way (NVLink 4)
CHIP_HBM_BYTES = 80 * 1024**3
VMEM_BYTES = 227 * 1024
