from . import adc
from . import block_scan
from . import flat_adc
from . import max_sim
from . import segment_ops
