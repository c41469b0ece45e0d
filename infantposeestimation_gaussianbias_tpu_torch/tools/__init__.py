"""Command-line tools of the port: ``probe_wmsa_ablate`` (K8, the phase
ablation of the W-MSA forward on the card)."""
