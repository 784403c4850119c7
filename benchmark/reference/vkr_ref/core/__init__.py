"""The runtime pieces the frozen frame needs: storage formats, FrameState,
the pass registry and the pass graph's add_task."""

from vkr_ref.core import graph, registry  # noqa: F401
from vkr_ref.core.framestate import FrameState  # noqa: F401
