from arkoserenderer.core.logging import get_logger  # noqa: F401
