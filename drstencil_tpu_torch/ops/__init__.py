"""Stencil operators: config, kernels, stream host side, gold, runner."""
