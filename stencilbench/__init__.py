"""The benchmark of drstencil_tpu_torch on the card; see README.md."""
