from .agents import AGENT_REGISTRY  # noqa: F401
from .mixers import MIXER_REGISTRY  # noqa: F401
