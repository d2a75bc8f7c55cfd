"""Downstream benchmark harness, PyTorch port of `omnibiote_tpu.evals`.

Entry points (each also a `python -m omnibiote_tpu_torch.evals.<name>` CLI
with the JAX package's flags plus --device; CUDA unless device="cpu"):
  gue.run_gue                  GUE DNA classification suite
  tape.run_tape                TAPE (ss3/ss8, remote homology, fluorescence,
                               stability)
  proteinglue.run_proteinglue  ProteinGLUE per-residue suite
  pronab.run_pronab            ProNAB binding affinity (crossval/train-all)
  pdb_contact.run_pdb_contact  PDB peptide-nucleotide contact
  contact.run_contact_eval     TAPE ProteinNet contact maps (pairwise
                               ResNet head, valid-masked BatchNorm)
  deepnap.run_deepnap          the DeePNAP CNN baseline for ProNAB

Shared pieces: common (batching, schedules, the three-group AdamW, the
linear head), metrics (scikit-learn's metrics in numpy), alignment
(char <-> token labels), engine (domain MLM, sequence classification),
token_finetune (per-token and single-target tasks).

`python3 tools/gpu_eval.py` runs all seven families on the card.
"""
