"""The benchmark's CPU tests (see ``conftest.py``)."""
