"""Analytical models: the roofline constants of the card."""
