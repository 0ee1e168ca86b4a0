"""Command-line interface of the port (`serve`; see `application.py`)."""
