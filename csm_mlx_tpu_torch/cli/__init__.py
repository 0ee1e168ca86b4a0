"""Command-line interface of the port: `generate`, `serve` and `finetune`
(see `application.py`)."""
