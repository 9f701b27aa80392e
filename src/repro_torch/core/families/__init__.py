"""Built-in payload families — importing this package registers them.

Registration order is match priority: packed container variants come
before their unpacked twins, and dense registers last because its
``matches`` claims any plain tensor.
"""
from . import sparse as _sparse            # noqa: F401
from . import quant as _quant              # noqa: F401
from . import dense as _dense              # noqa: F401
