"""Spectroscopy of the real-gas model: q and T profiles, wavenumber bands,
HITRAN line lists and absorption-coefficient lookup tables (host NumPy)."""
