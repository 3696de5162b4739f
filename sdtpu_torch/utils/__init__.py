"""Host utilities of the entry points (this package's copies of ``sdtpu/utils``)."""
