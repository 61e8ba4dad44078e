"""Front door of the port (mirrors ``repro.api``)."""
from repro_torch.api.results import RunReport, ServeReport
from repro_torch.api.session import PrivacySpec, ProtocolSession, Session

__all__ = ["PrivacySpec", "ProtocolSession", "RunReport", "ServeReport",
           "Session"]
