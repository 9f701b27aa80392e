"""Built-in payload families — importing this package registers them.

Registration order is match priority (``payload_registry.unwrap_payload``
and friends walk it front to back), and it is the reference's: packed
container variants come before their unpacked twins so a bit-packed
payload resolves to its container family first, and dense registers last
because its ``matches`` claims any plain tensor.
"""
from . import sparse as _sparse            # noqa: F401
from . import int2 as _int2                # noqa: F401
from . import quant as _quant              # noqa: F401
from . import gsparse as _gsparse          # noqa: F401
from . import perchannel as _perchannel    # noqa: F401
from . import bfp8 as _bfp8                # noqa: F401
from . import actsparse as _actsparse      # noqa: F401
from . import dense as _dense              # noqa: F401
