"""Scene-generation service: request parsing, grouping into padded batches,
micro-batching of concurrent clients, and the HTTP / batch-file CLI."""
from .batcher import MicroBatcher  # noqa: F401
from .service import GenerationService, request_to_example  # noqa: F401
