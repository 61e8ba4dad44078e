"""Front door of the port (mirrors ``repro.api``)."""
from repro_torch.api.results import RunReport
from repro_torch.api.session import PrivacySpec, ProtocolSession, Session

__all__ = ["PrivacySpec", "ProtocolSession", "RunReport", "Session"]
