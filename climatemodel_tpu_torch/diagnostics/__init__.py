"""Diagnostics: equilibrium sensitivities, OLR analysis and animation."""
