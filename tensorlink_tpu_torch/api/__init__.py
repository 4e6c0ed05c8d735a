"""HTTP serving layer.

Reference: tensorlink/api (FastAPI + uvicorn, api/node.py:94) with OpenAI-
compatible schemas (api/models.py) and prompt/response formatting
(ml/formatter.py). This environment ships no fastapi/uvicorn/pydantic, so the
server is stdlib asyncio HTTP with dataclass schemas — same routes, same
response shapes, same SSE wire format.
"""

from tensorlink_tpu_torch.api.server import TensorlinkAPI

__all__ = ["TensorlinkAPI"]
