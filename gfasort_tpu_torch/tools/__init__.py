"""Tools of the port: the synthetic pangenome GFA generator
(``python -m gfasort_tpu_torch.tools.make_synthetic_gfa ...``) and the
shift-sum probe (``python -m gfasort_tpu_torch.tools.dense_probe``)."""
