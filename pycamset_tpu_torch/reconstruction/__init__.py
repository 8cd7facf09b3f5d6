"""The reconstruction exports: MVSNet / ACMMP view pairs (``acmmp_utils``)."""
