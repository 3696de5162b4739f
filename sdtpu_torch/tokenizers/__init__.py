"""Tokenizers of the FLUX path (this package's copies of ``sdtpu/tokenizers``)."""
