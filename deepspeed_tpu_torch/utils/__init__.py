from .logging import logger, warning_once

__all__ = ["logger", "warning_once"]
