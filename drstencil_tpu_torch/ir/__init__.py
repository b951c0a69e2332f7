"""Stencil IR: `.stc` front-end, analysis passes, fp64 golden model."""
