"""Command-line tools of the port that run beside the CLI (``quality_serving``)."""
