"""The benchmark's own tests: ``python -m pytest kmls_bench/tests`` from the
repository root (``-m cuda`` on the card for the tests that need it)."""
