"""Tuned configurations and the card's roofline."""
