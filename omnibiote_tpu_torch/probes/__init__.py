"""Roofline probes of the port's attention kernels on the H100.

`roofline` and `roofline2` are the port's counterparts of
`tools/probes/roofline.py` and `roofline2.py`: the products of the flash
attention kernels without softmax, mask or dropout
(`ops/csrc/roofline_probes.cu`), each with its plain PyTorch version. #1's
two products (`dots_only`, and `dots` with k pre-transposed or not), the
dkv product mix (`dots_n`) and the score product summed over heads
(`scores`) all run on wgmma fed by TMA, as the rebuilt attention kernels
do.
Importing them runs nothing; on a card,

    python -m omnibiote_tpu_torch.probes.roofline
    python -m omnibiote_tpu_torch.probes.roofline2

print the probes' tables.
"""
