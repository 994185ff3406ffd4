"""Tools of the port: the synthetic pangenome GFA generator
(``python -m gfasort_tpu_torch.tools.make_synthetic_gfa ...``), the
shift-sum probe (``python -m gfasort_tpu_torch.tools.dense_probe``) and
the bucket kernels' A/B timer against an earlier build of their sources
(``python -m gfasort_tpu_torch.tools.kernel_ab OLD_DIR``)."""
