"""The privacy audit lab (port of ``repro.audit``): what the network
reveals (``transcript``), who is listening (``threat``), attacks on the
recordings (``attacks``), what was promised (``ledger``) and the noise
generator itself (``mechanisms``), so that alternative and deliberately
broken mechanisms face the same battery::

    from repro_torch.audit import (AuditConfig, LOCAL_EAVESDROPPER,
                                   distinguishing_attack, get_mechanism)
    r = distinguishing_attack(LOCAL_EAVESDROPPER,
                              mechanism=get_mechanism("laplace"),
                              audit=AuditConfig(trials=2000))
    assert not r.flagged
"""
from repro_torch.audit.attacks import (
    AuditConfig,
    DistinguishingResult,
    EpsilonEstimate,
    clopper_pearson,
    distinguishing_attack,
    empirical_epsilon_lower_bound,
    example_scores,
    membership_inference,
    reconstruction_attack,
)
from repro_torch.audit.ledger import PrivacyLedger
from repro_torch.audit.mechanisms import (
    MECHANISMS,
    GaussianMechanism,
    GraphHomomorphicMechanism,
    LaplaceMechanism,
    NoiseMechanism,
    get_mechanism,
    theoretical_epsilon,
)
from repro_torch.audit.threat import (
    CURIOUS_NEIGHBOR,
    GLOBAL_OBSERVER,
    LOCAL_EAVESDROPPER,
    THREAT_MODELS,
    Observation,
    ThreatModel,
)
from repro_torch.audit.transcript import Transcript, TranscriptTap

__all__ = [
    "AuditConfig",
    "CURIOUS_NEIGHBOR",
    "DistinguishingResult",
    "EpsilonEstimate",
    "GLOBAL_OBSERVER",
    "GaussianMechanism",
    "GraphHomomorphicMechanism",
    "LOCAL_EAVESDROPPER",
    "LaplaceMechanism",
    "MECHANISMS",
    "NoiseMechanism",
    "Observation",
    "PrivacyLedger",
    "THREAT_MODELS",
    "ThreatModel",
    "Transcript",
    "TranscriptTap",
    "clopper_pearson",
    "distinguishing_attack",
    "empirical_epsilon_lower_bound",
    "example_scores",
    "get_mechanism",
    "membership_inference",
    "reconstruction_attack",
    "theoretical_epsilon",
]
