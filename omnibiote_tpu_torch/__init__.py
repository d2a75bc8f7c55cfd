"""omnibiote_tpu_torch: the PyTorch/CUDA port of omnibiote_tpu for an
NVIDIA H100.

Public surface (what the port has so far; see ROADMAP.md):
  * config.OmniBioTAConfig — typed model configuration
  * models.omnibiota — OmniBioTA / init_params / forward / encode
  * ops — multi-head flash attention (hand-written CUDA kernel), segment
    ids, the dense reference attention
  * tokenizer — SentencePiece-compatible BPE (C++ core, ctypes binding)
  * api.Encoder — strings in, pooled embeddings out
"""
from .config import (
    OmniBioTAConfig,
    preset,
    EOS_TOKEN,
    PAD_TOKEN,
    MASK_TOKEN,
    UNK_TOKEN,
    BANNED_TOKEN,
)
from .models.omnibiota import OmniBioTA, init_params, forward, encode, num_params

__version__ = "0.1.0"
