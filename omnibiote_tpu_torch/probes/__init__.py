"""Roofline probes of the port's attention kernels on the H100.

`roofline` and `roofline2` are the port's counterparts of
`tools/probes/roofline.py` and `roofline2.py`: the products of the flash
attention kernels without softmax, mask or dropout, on the same CTA tiles,
cp.async ring and mma.sync fragments as the kernels they measure
(`ops/csrc/roofline_probes.cu`), each with its plain PyTorch version.
Importing them runs nothing; on a card,

    python -m omnibiote_tpu_torch.probes.roofline
    python -m omnibiote_tpu_torch.probes.roofline2

print the probes' tables.
"""
