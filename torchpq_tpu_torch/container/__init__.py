from .base import BaseContainer
from .flat import FlatContainer
from .cell import CellContainer
from .group import FlatContainerGroup
