from .base import BaseCodec
from .vq import VQCodec
from .pq import PQCodec
from .sq import SQCodec
