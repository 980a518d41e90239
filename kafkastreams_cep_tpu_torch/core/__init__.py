from .dewey import DeweyVersion
from .event import Event
from .sequence import Sequence, SequenceBuilder, Staged

__all__ = ["DeweyVersion", "Event", "Sequence", "SequenceBuilder", "Staged"]
