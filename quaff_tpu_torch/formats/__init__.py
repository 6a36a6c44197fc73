from .alignment import Alignment, AlignmentPrinter, OutputFormat  # noqa: F401
