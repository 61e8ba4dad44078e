"""Privacy audit (mirrors ``repro.audit``): so far the privacy ledger. The
mechanisms, transcript tap, threat views and attack battery are ROADMAP
Queue 1 item 9."""
from repro_torch.audit.ledger import PrivacyLedger

__all__ = ["PrivacyLedger"]
