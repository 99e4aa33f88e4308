from .base import BaseContainer
from .cell import CellContainer
