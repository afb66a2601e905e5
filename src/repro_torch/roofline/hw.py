"""NVIDIA H100 figures for the dry run's roofline and the card's bounds.

Each figure is for an NVIDIA H100 80GB HBM3 (the SXM part) at its full
power limit, 700.00 W, the card ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` names on the machine
the port is measured on.  A card set below 700 W runs slower under load
than these peaks.  Nothing here imports anything: ``chip_smoke.py`` loads
this file by its path.
"""

# NVIDIA H100 80GB HBM3, 700.00 W: bf16 tensor cores, dense (no
# sparsity), NVIDIA's H100 SXM data sheet
PEAK_FLOPS_BF16 = 989e12          # FLOP/s per card
# NVIDIA H100 80GB HBM3, 700.00 W: HBM3, NVIDIA's H100 SXM data sheet
HBM_BW = 3.35e12                  # bytes/s per card
# NVIDIA H100 80GB HBM3, 700.00 W: NVLink 4, 900 GB/s a card over 18
# links (NVIDIA's H100 SXM data sheet), both directions together
NVLINK_LINK_BW = 900e9 / 18       # bytes/s per link
# NVIDIA H100 80GB HBM3, 700.00 W: device memory as
# torch.cuda.get_device_properties(0).total_memory reads it on the card
HBM_BYTES = 85_017_493_504        # bytes per card
# NVIDIA H100 80GB HBM3: shared memory a streaming multiprocessor (the
# most a CTA may take is 227 KiB), NVIDIA's Hopper tuning guide
SMEM_BYTES = 228 * 2**10

# the production meshes' sizes (launch.mesh.make_production_mesh)
SINGLE_POD_CHIPS = 256
MULTI_POD_CHIPS = 512
