"""TAPE contact prediction (ProteinNet), PyTorch port of
`omnibiote_tpu/evals/contact.py`.

The reference's evals/TAPE/contact_eval_full.py.py protocol:
  * ProteinNet JSON -> pairwise distance matrices -> contact maps (< 8 A),
    valid-mask outer products, medium (12-23) / long (>=24) range masks
  * char->token contact-map downsampling by max-pooling over piece spans
    (process_sample, :86-125) with a pickle cache; token->char upsampling
    for evaluation (:127-143)
  * model embeddings -> Linear(d, 128) head -> pairwise outer concat
    (2*128 channels) -> ContactPredictor CNN (conv3x3 -> residual blocks
    with BatchNorm + LeakyReLU -> conv3x3 -> sigmoid) (:184-215)
  * masked BCE over valid & non-short-range pairs (:409-417); 4 LR groups
    (wte/rest/head/cnn) with OneCycleLR and a global-norm clip at 1.0
    (:368-377, :454); best model by val medium+long precision sum; pooled
    precision and AUPRC for medium and long ranges (:300-355)

As in the JAX package, pair images are bucketed to multiples of 64 tokens
and the batch-norm statistics cover VALID positions only (the padded border
is excluded), in training and in prediction alike: the CNN keeps no running
statistics. Rows of T = L + 2 tokens are a multiple of 128 only at the top
bucket (L = 1022), so only those reach the flash kernels; every other bucket
takes the dense attention path, as in the JAX package.

Usage:
  python -m omnibiote_tpu_torch.evals.contact TOKENIZER CHECKPOINT BANNED_ID \
      --data_dir datasets/TAPE/data [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import PAD_TOKEN
from ..ops.segments import padding_segment_ids_torch
from ..tokenizer import SentencePieceProcessor
from ..training.checkpoint import load_model_checkpoint
from ..training.train import slot_seed
from .common import (
    adamw, apply_linear_head, group_label_tree, init_linear_head, onecycle, restore,
    snapshot, step_optimizer, to_device, trainable)
from .metrics import auc, precision_recall_curve, precision_score

HEAD_DIM = 128
CNN_CHANNELS = 64
BUCKET = 64
MAX_TOKENS = 1022  # pair image side; inputs carry +2 for <protein>/<EOS>


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------

def load_proteinnet(split: str, base_dir: str):
    """(:44-77): sequences, contact maps, pair masks, range masks."""
    with open(os.path.join(base_dir,
                           f"proteinnet/proteinnet_{split}.json")) as f:
        data = json.load(f)
    seqs, cmaps, masks, med_masks, long_masks = [], [], [], [], []
    for item in data:
        seqs.append(item["primary"])
        tertiary = np.asarray(item["tertiary"], np.float64)
        dm = np.linalg.norm(
            tertiary[:, None, :] - tertiary[None, :, :], axis=2)
        m = np.float32(item["valid_mask"]).reshape(-1, 1)
        masks.append(m @ m.T)
        idx = np.abs(np.arange(len(tertiary))
                     - np.arange(len(tertiary))[:, None])
        med_masks.append(np.logical_and(idx >= 12, idx <= 23))
        long_masks.append(idx >= 24)
        cmaps.append(dm < 8)
    return seqs, cmaps, masks, med_masks, long_masks


def process_sample(sp, sequence, contact_map, mask, banned_token: int):
    """char->token max-pool downsampling (:86-125)."""
    n = len(contact_map)
    idx = np.abs(np.arange(n) - np.arange(n)[:, None])
    non_short = idx >= 12

    tokenized = [t for t in sp.encode("<protein>" + sequence + "<EOS>")
                 if t != banned_token]
    token_lens = [len(sp.decode([t])) for t in tokenized]

    masked_cm = contact_map * mask
    inner = len(tokenized) - 2
    tcm = np.zeros((inner, inner), np.float32)
    tmask = np.zeros((inner, inner), np.float32)
    tnsr = np.zeros((inner, inner), np.float32)

    # cumulative spans over the inner tokens
    spans = []
    p = 0
    for L in token_lens[1:-1]:
        spans.append((p, p + L))
        p += L
    for i, (a0, a1) in enumerate(spans):
        for j, (b0, b1) in enumerate(spans):
            tcm[i, j] = np.max(masked_cm[a0:a1, b0:b1])
            tmask[i, j] = np.max(mask[a0:a1, b0:b1])
            tnsr[i, j] = np.max(non_short[a0:a1, b0:b1])
    return tokenized, tcm, tmask, tnsr


def inverse_process_sample(sp, tokenized, pred_map):
    """token->char upsampling (:127-143). Reproduces the reference's
    off-by-one: token_lens is computed over tokenized[1:-1] and then
    re-sliced [1:-1], so only the 2nd..second-to-last inner tokens' blocks
    are laid out, from the top left (each block holding the prediction of
    the token before it), and as many trailing rows/cols as the first and
    last inner tokens have characters stay zero; the returned map side is
    sum(token_lens of the inner tokens)."""
    token_lens = [len(sp.decode([int(t)])) for t in tokenized[1:-1]]
    side = int(np.sum(token_lens))
    out = np.zeros((side, side), np.float32)
    idx_i = 0
    for i, lx in enumerate(token_lens[1:-1]):
        idx_j = 0
        for j, ly in enumerate(token_lens[1:-1]):
            out[idx_i:idx_i + lx, idx_j:idx_j + ly] = pred_map[i, j]
            idx_j += ly
        idx_i += lx
    return out


def preprocess_split(sp, seqs, cmaps, masks, banned_token,
                     cache_path: str = None):
    """(tokens, token contact maps, token masks, token non-short-range
    masks) of every sample. With cache_path, read from that pickle when it
    exists (the JAX package writes the same one), else written there."""
    if cache_path and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    toks, tcms, tmasks, tnsrs = [], [], [], []
    for s, c, m in zip(seqs, cmaps, masks):
        t, tc, tm, tn = process_sample(sp, s, c, m, banned_token)
        toks.append(t)
        tcms.append(tc)
        tmasks.append(tm)
        tnsrs.append(tn)
    out = (toks, tcms, tmasks, tnsrs)
    if cache_path:
        with open(cache_path, "wb") as f:
            pickle.dump(out, f)
    return out


# --------------------------------------------------------------------------
# CNN (ContactPredictor, :184-215) — masked BatchNorm
# --------------------------------------------------------------------------

class MaskedBatchNorm(nn.Module):
    """BatchNorm2d's batch-statistics normalisation with the mean and the
    biased variance taken over valid positions only (mask (N, 1, H, W) in
    {0, 1}), then a per-channel scale and bias. It is the same in training
    and in prediction: nn.BatchNorm2d would average over the PAD border in
    train mode and use running statistics in eval mode, which the JAX model
    never keeps."""

    def __init__(self, channels: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x, mask):
        cnt = mask.sum().clamp_min(1.0)
        mean = (x * mask).sum((0, 2, 3), keepdim=True) / cnt
        var = (((x - mean) ** 2) * mask).sum((0, 2, 3), keepdim=True) / cnt
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale[None, :, None, None] + self.bias[None, :, None, None]


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, device=device)
        self.bn1 = MaskedBatchNorm(channels, device=device)
        self.bn2 = MaskedBatchNorm(channels, device=device)

    def forward(self, out, mask):
        h = F.leaky_relu(self.bn1(self.conv1(out), mask), 0.01) * mask
        h = F.leaky_relu(self.bn2(self.conv2(h), mask), 0.01) * mask
        return out + h


class ContactPredictor(nn.Module):
    """conv3x3 (SAME) -> residual blocks -> conv3x3 -> sigmoid over a
    (N, C, H, W) pair image and its valid mask (N, 1, H, W). Every stage is
    re-masked: zeroing outside the mask makes the PAD region behave like
    the convs' zero padding, so predictions on the real region do not
    depend on the bucket width (the JAX package's apply_contact_predictor)."""

    def __init__(self, in_channels: int = 2 * HEAD_DIM, channels: int = CNN_CHANNELS,
                 blocks: int = 8, *, device=None):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, channels, 3, padding=1, device=device)
        self.blocks = nn.ModuleList(ResidualBlock(channels, device=device)
                                    for _ in range(blocks))
        self.conv_out = nn.Conv2d(channels, 1, 3, padding=1, device=device)

    def forward(self, x, mask):
        out = self.conv_in(x * mask) * mask
        for blk in self.blocks:
            out = blk(out, mask)
        return torch.sigmoid(self.conv_out(out))


@torch.no_grad()
def init_contact_predictor(generator: torch.Generator, *, in_channels: int = 2 * HEAD_DIM,
                           channels: int = CNN_CHANNELS, blocks: int = 8,
                           device=None) -> ContactPredictor:
    """A ContactPredictor with torch's Conv2d default init, U(±1/sqrt(fan_in))
    for every conv's weight and bias, drawn from `generator` (on its device)
    in the JAX package's order: conv_in, conv_out, then each block's conv1
    and conv2. Batch-norm scales 1, biases 0."""
    cnn = ContactPredictor(in_channels, channels, blocks, device=device)
    convs = [cnn.conv_in, cnn.conv_out] + [c for b in cnn.blocks for c in (b.conv1, b.conv2)]
    for conv in convs:
        bound = 1.0 / np.sqrt(conv.weight[0].numel())
        for p in (conv.weight, conv.bias):
            p.copy_(torch.empty(p.shape, device=generator.device).uniform_(
                -bound, bound, generator=generator))
    return cnn


# --------------------------------------------------------------------------
# Training / evaluation
# --------------------------------------------------------------------------

def _bucket(n):
    return min(((n + BUCKET - 1) // BUCKET) * BUCKET, MAX_TOKENS)


def _pad_sample(tok, tcm, tmask, tnsr):
    n = tcm.shape[0]
    L = _bucket(max(n, 8))
    tok_p = np.full((1, L + 2), PAD_TOKEN, np.int32)
    tok_p[0, :len(tok)] = np.asarray(tok[:L + 2], np.int32)
    cm = np.zeros((L, L), np.float32)
    mk = np.zeros((L, L), np.float32)
    ns = np.zeros((L, L), np.float32)
    cm[:n, :n] = tcm[:L, :L]
    mk[:n, :n] = tmask[:L, :L]
    ns[:n, :n] = tnsr[:L, :L]
    return tok_p, cm, mk, ns


def pair_features(model, head, tokens, rng=None):
    """(1, 2*HEAD_DIM, n, n) fp32 pair image of a (1, n + 2) token row: the
    inner tokens' embeddings through the linear head (in the embeddings'
    dtype, as the JAX package applies it; fp32 after), each pair (i, j) the
    concatenation of row i's and row j's. PAD positions are invisible to
    attention (the reference forwards unpadded batch-1 samples), so no
    real token's embedding depends on the bucket. rng: the integer dropout
    seed of a training forward (None: deterministic)."""
    det = rng is None or model.cfg.dropout == 0.0
    segs = padding_segment_ids_torch(tokens, PAD_TOKEN)
    emb = model(tokens, segs, deterministic=det, rng=None if det else rng,
                return_embeddings=True)[:, 1:-1]
    emb = apply_linear_head(head, emb).float()
    n = emb.shape[1]
    f = torch.cat([emb[:, :, None, :].expand(1, n, n, -1),
                   emb[:, None, :, :].expand(1, n, n, -1)], dim=-1)
    return f.permute(0, 3, 1, 2)


def contact_loss(model, head, cnn, tokens, cm, mask, nsr, weight, rng=None):
    """BCE (eps 1e-7) of the predicted map over the valid, non-short-range
    pairs, averaged over them and scaled by `weight`."""
    feats = pair_features(model, head, tokens, rng)
    probs = cnn(feats, mask[None, None])[0, 0]
    eps = 1e-7
    bce = -(cm * torch.log(probs + eps) + (1 - cm) * torch.log(1 - probs + eps))
    sel = mask * nsr
    return torch.sum(bce * sel) / sel.sum().clamp_min(1.0) * weight


def predict_map(model, head, cnn, tokens, mask):
    """(L, L) contact probabilities of one bucketed token row."""
    with torch.inference_mode():
        feats = pair_features(model, head, tokens)
        return cnn(feats, mask[None, None])[0, 0]


def clip_grad_global_norm(params, max_norm: float = 1.0) -> torch.Tensor:
    """optax.clip_by_global_norm over the .grad of `params` together: when
    the global norm g reaches max_norm, every gradient becomes
    (grad / g) * max_norm. Returns g."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div).mul_(mul)
    return norm


def make_contact_optimizer(model, head, cnn, *, lr: float, embed_lr: float,
                           head_lr: float, contact_pred_lr: float, total_steps: int):
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-2 on every
    parameter) over four groups, wte at embed_lr, the rest of the model at
    lr, the head at head_lr and the CNN at contact_pred_lr, each on a
    one-cycle schedule (:368-377). Returns (optimizer, scheduler)."""
    groups = group_label_tree(model, head)
    return adamw([[p for _, p in groups[g]] for g in ("wte", "rest", "head")]
                 + [list(cnn.parameters())],
                 [onecycle(peak, total_steps)
                  for peak in (embed_lr, lr, head_lr, contact_pred_lr)])


def evaluate_dataset(sp, predict, toks, cmaps, masks, med_masks, long_masks, tmasks):
    """Pooled medium/long precision and AUPRC (:300-355). predict(tokens,
    mask) -> (L, L) numpy probabilities of a bucketed sample."""
    med_gt, med_pred, med_prob = [], [], []
    long_gt, long_pred, long_prob = [], [], []
    for i, tok in enumerate(toks):
        if len(tok) <= 5 or len(tok) - 2 > MAX_TOKENS:
            continue
        tok_p, _, mk, _ = _pad_sample(tok, np.zeros((len(tok) - 2,) * 2, np.float32),
                                      tmasks[i], tmasks[i] * 0 + 1)
        probs_tok = predict(tok_p, mk)
        n = len(tok) - 2
        pred_map = inverse_process_sample(sp, tok, probs_tok[:n, :n])
        cm, mask = cmaps[i], masks[i]
        side = pred_map.shape[0]
        cm = cm[:side, :side]
        mask = mask[:side, :side]
        mrm = med_masks[i][:side, :side]
        lrm = long_masks[i][:side, :side]
        preds = pred_map > 0.5
        sel_m = (mask * mrm) == 1
        sel_l = (mask * lrm) == 1
        med_gt.extend(cm[sel_m].ravel())
        med_pred.extend(preds[sel_m].ravel())
        med_prob.extend(pred_map[sel_m].ravel())
        long_gt.extend(cm[sel_l].ravel())
        long_pred.extend(preds[sel_l].ravel())
        long_prob.extend(pred_map[sel_l].ravel())

    def safe_prec(gt, pr):
        return float(precision_score(gt, pr, zero_division=0)) if gt else 0.0

    def safe_auprc(gt, prob):
        if not gt or len(set(map(bool, gt))) < 2:
            return 0.0
        p, r, _ = precision_recall_curve(gt, prob)
        return float(auc(r, p))

    return (safe_prec(med_gt, med_pred), safe_prec(long_gt, long_pred),
            safe_auprc(med_gt, med_prob), safe_auprc(long_gt, long_prob))


def run_contact_eval(
    tokenizer_fn: str,
    model_fn: str,
    banned_token: int = 65533,
    data_dir: str = "../datasets/TAPE/data",
    num_epochs: int = 128,
    num_accumulation_steps: int = 128,
    num_tests: int = 256,
    lr: float = 1e-4,
    embed_lr: float = 1e-4,
    head_lr: float = 1e-3,
    contact_pred_lr: float = 1e-3,
    resnet_blocks: int = 8,
    seed: int = 0,
    cache: bool = True,
    metrics_sink=None,
    device=None,
):
    """Fine-tune the model, the head and the CNN on the train split, with a
    validation every num_steps // num_tests steps, and return
    {"test": ..., "test_best": ...}, each (medium precision, long precision,
    medium AUPRC, long AUPRC) of the final and the best-on-val model.
    device: None (the GPU) or e.g. "cpu"."""
    sp = SentencePieceProcessor(tokenizer_fn)
    model, cfg = load_model_checkpoint(model_fn, device=device)
    dev = next(model.parameters()).device

    tr = load_proteinnet("train", data_dir)
    va = load_proteinnet("valid", data_dir)
    te = load_proteinnet("test", data_dir)
    cache_path = (os.path.join(data_dir,
                               "proteinnet/processed_train_bpe_mixed.pkl")
                  if cache else None)
    tr_tok, tr_cm, tr_mask, tr_nsr = preprocess_split(
        sp, tr[0], tr[1], tr[2], banned_token, cache_path)
    va_pre = preprocess_split(sp, va[0], va[1], va[2], banned_token)
    te_pre = preprocess_split(sp, te[0], te[1], te[2], banned_token)
    va_tok, va_tmask = va_pre[0], va_pre[2]
    te_tok, te_tmask = te_pre[0], te_pre[2]

    gen = torch.Generator().manual_seed(seed)
    head = init_linear_head(gen, cfg.n_embd, HEAD_DIM, device=dev)
    cnn = init_contact_predictor(gen, blocks=resnet_blocks, device=dev)
    live = trainable(model, head)
    live.update({f"cnn.{n}": p for n, p in cnn.named_parameters()})

    num_steps = max(1, int(num_epochs * len(tr_tok) / num_accumulation_steps))
    opt, sched = make_contact_optimizer(
        model, head, cnn, lr=lr, embed_lr=embed_lr, head_lr=head_lr,
        contact_pred_lr=contact_pred_lr, total_steps=num_steps)
    rng_np = np.random.default_rng(seed)

    def predict(tok_p, mk):
        return predict_map(model, head, cnn, *to_device(model, tok_p, mk)).cpu().numpy()

    best_sum = 0.0
    best = None
    val_every = max(1, num_steps // num_tests)
    results = {}

    for step in range(num_steps):
        drawn = False
        for j in range(num_accumulation_steps):
            i = int(rng_np.integers(0, len(tr_tok)))
            if len(tr_tok[i]) <= 5 or len(tr_tok[i]) - 2 > MAX_TOKENS:
                continue
            tok_p, cm, mk, ns = _pad_sample(tr_tok[i], tr_cm[i], tr_mask[i], tr_nsr[i])
            contact_loss(model, head, cnn, *to_device(model, tok_p, cm, mk, ns),
                         1.0 / num_accumulation_steps,
                         rng=slot_seed(seed + 52000, step, j)).backward()
            drawn = True
        if drawn:
            clip_grad_global_norm(live.values(), 1.0)
            step_optimizer(opt, sched)

        if step % val_every == 0:
            mp, lp, ma, la = evaluate_dataset(
                sp, predict, va_tok, va[1], va[2], va[3], va[4], va_tmask)
            rec = {"step": step, "val/medium_precision": mp,
                   "val/long_precision": lp, "val/medium_auprc": ma,
                   "val/long_auprc": la}
            if metrics_sink:
                metrics_sink.log(rec)
            if mp + lp > best_sum:
                best_sum = mp + lp
                best = snapshot(live, best)

    # final + best test eval (:460-480)
    results["test"] = evaluate_dataset(
        sp, predict, te_tok, te[1], te[2], te[3], te[4], te_tmask)
    if best is not None:
        restore(live, best)
    results["test_best"] = evaluate_dataset(
        sp, predict, te_tok, te[1], te[2], te[3], te[4], te_tmask)
    for name, (mp, lp, ma, la) in results.items():
        print(f"{name}: medium_precision {mp:.4f} long_precision {lp:.4f} "
              f"medium_auprc {ma:.4f} long_auprc {la:.4f}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="TAPE contact prediction eval")
    ap.add_argument("tokenizer_fn")
    ap.add_argument("model_fn")
    ap.add_argument("banned_token", type=int)
    ap.add_argument("--data_dir", default="../datasets/TAPE/data")
    ap.add_argument("--num_epochs", type=int, default=128)
    ap.add_argument("--num_accumulation_steps", type=int, default=128)
    ap.add_argument("--num_tests", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--embed_lr", type=float, default=1e-4)
    ap.add_argument("--head_lr", type=float, default=1e-3)
    ap.add_argument("--contact_pred_lr", type=float, default=1e-3)
    ap.add_argument("--resnet_blocks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_cache", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    a = ap.parse_args(argv)
    return run_contact_eval(
        a.tokenizer_fn, a.model_fn, a.banned_token, data_dir=a.data_dir,
        num_epochs=a.num_epochs,
        num_accumulation_steps=a.num_accumulation_steps,
        num_tests=a.num_tests, lr=a.lr, embed_lr=a.embed_lr,
        head_lr=a.head_lr, contact_pred_lr=a.contact_pred_lr,
        resnet_blocks=a.resnet_blocks, seed=a.seed, cache=not a.no_cache,
        device=a.device)


if __name__ == "__main__":
    main()
