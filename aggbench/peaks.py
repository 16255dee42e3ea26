"""Published peaks of the cards a run may report, by the name that
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM5 80 GB data sheet: 3.35 TB/s of HBM3 bandwidth, at the
full 700 W power limit (a card set lower reads below it).
"""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
