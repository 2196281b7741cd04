"""CPU tests of the benchmark (run them with ``python -m pytest -q
bench/tests`` from the root; the repository's ``testpaths`` is
``tests``)."""
