"""Template fingerprinting shared by workload controllers.

The counterpart of `kubernetes_tpu/controllers/revision.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller/history (ControllerRevision hashing) and the
pod-template-hash / controller-revision-hash labels. One canonical formula:
the template's WIRE FORM serialized with sorted keys — so labels,
annotations (rollout restart patches only an annotation), and every spec
field participate, and dict key order in the manifest cannot produce
spurious rollouts.
"""

from __future__ import annotations

import hashlib
import json


REVISION_LABEL = "controller-revision-hash"


def template_fingerprint(template) -> str:
    """Stable 10-hex-char digest of a PodTemplateSpec."""
    from ..api.serialize import _template_to_dict

    canon = json.dumps(_template_to_dict(template), sort_keys=True)
    return hashlib.sha1(canon.encode()).hexdigest()[:10]


def revision_name(owner_name: str, template) -> str:
    """<owner>-<fingerprint> — the value pods carry in REVISION_LABEL."""
    return f"{owner_name}-{template_fingerprint(template)}"
