"""Checkpoint IO for the FLUX path (this package's copies of ``sdtpu/io``)."""
