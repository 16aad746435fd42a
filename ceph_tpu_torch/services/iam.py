"""S3 bucket-policy documents: parse, validate, evaluate.

Counterpart of ceph_tpu/services/iam.py: the same module over the
port's imports.

Reference src/rgw/rgw_iam_policy.{h,cc}: IAM policy JSON attached to a
bucket, evaluated per request as (principal, action, resource) against
each statement; the verdict lattice is explicit Deny > Allow > default
(fall through to ACLs).  This is the same evaluation order the
reference implements in rgw_op.cc verify_permission (policy first,
deny short-circuits, default falls back to ACL grants).

Scope: the Principal/Action/NotAction/Resource/Effect statement core
with S3-style ``*`` wildcards.  Condition blocks are NOT supported and
are rejected at validation time — silently ignoring a condition would
grant more than the document says, the one failure mode a policy
engine must never have.
"""

from __future__ import annotations

import json
import re

ARN_S3_PREFIX = "arn:aws:s3:::"
ARN_USER_PREFIX = "arn:aws:iam:::user/"

# Exactly the actions the enforcement paths evaluate (rgw.py data-path
# _check_bucket annotations).  Bucket administration (ACL/policy/
# notification/versioning config) is NOT policy-evaluated — it stays
# owner/ACL-gated — so granting those actions would be silently inert;
# validation rejects them instead.
KNOWN_ACTIONS = frozenset({
    "s3:*",
    "s3:GetObject", "s3:GetObjectVersion",
    "s3:PutObject", "s3:DeleteObject", "s3:DeleteObjectVersion",
    "s3:ListBucket", "s3:ListBucketVersions",
    "s3:ListBucketMultipartUploads", "s3:AbortMultipartUpload",
    "s3:PutObjectRetention", "s3:GetObjectRetention",
    "s3:PutObjectLegalHold", "s3:GetObjectLegalHold",
    "s3:BypassGovernanceRetention",
    "s3:PutObjectTagging", "s3:GetObjectTagging", "s3:DeleteObjectTagging",
})


class PolicyError(ValueError):
    """Malformed policy document (maps to S3 MalformedPolicy)."""


def _listify(v) -> list:
    if isinstance(v, list):
        return v
    return [v]


def _principals(stmt: dict) -> list[str]:
    """Normalized principal ids; '*' means everyone incl. anonymous."""
    p = stmt.get("Principal")
    if p == "*":
        return ["*"]
    if isinstance(p, dict) and "AWS" in p:
        out = []
        for ent in _listify(p["AWS"]):
            if not isinstance(ent, str):
                raise PolicyError("Principal entries must be strings")
            if ent.startswith(ARN_USER_PREFIX):
                ent = ent[len(ARN_USER_PREFIX):]
            out.append(ent)
        return out
    raise PolicyError("Principal must be \"*\" or {\"AWS\": [...]}")


def _norm_resource(r: str) -> str:
    if r.startswith(ARN_S3_PREFIX):
        r = r[len(ARN_S3_PREFIX):]
    if not r:
        raise PolicyError("empty Resource")
    return r


def validate(doc: str | dict) -> dict:
    """Parse + validate a policy document; returns the parsed dict.
    Raises PolicyError on anything the evaluator would not honor
    exactly (unknown actions, Condition blocks, bad principals)."""
    if isinstance(doc, (str, bytes)):
        try:
            doc = json.loads(doc)
        except ValueError as e:
            raise PolicyError(f"not JSON: {e}") from None
    if not isinstance(doc, dict):
        raise PolicyError("policy must be a JSON object")
    stmts = doc.get("Statement")
    if not isinstance(stmts, list) or not stmts:
        raise PolicyError("Statement must be a non-empty list")
    for stmt in stmts:
        if not isinstance(stmt, dict):
            raise PolicyError("statements must be objects")
        if stmt.get("Effect") not in ("Allow", "Deny"):
            raise PolicyError("Effect must be Allow or Deny")
        if "Condition" in stmt:
            raise PolicyError("Condition blocks are not supported")
        if "NotPrincipal" in stmt:
            raise PolicyError("NotPrincipal is not supported")
        if "NotResource" in stmt:
            raise PolicyError("NotResource is not supported")
        if ("Action" in stmt) == ("NotAction" in stmt):
            raise PolicyError(
                "exactly one of Action/NotAction is required")
        for a in _listify(stmt.get("Action", stmt.get("NotAction"))):
            if not isinstance(a, str) or not a.startswith("s3:"):
                raise PolicyError(f"bad action {a!r}")
            if "*" not in a and a not in KNOWN_ACTIONS:
                raise PolicyError(f"unknown action {a!r}")
        _principals(stmt)
        resources = _listify(stmt["Resource"]) if "Resource" in stmt \
            else []
        if not resources:
            raise PolicyError("Resource is required")
        for r in resources:
            if not isinstance(r, str):
                raise PolicyError("Resource entries must be strings")
            _norm_resource(r)
    return doc


def _wild_match(pattern: str, value: str) -> bool:
    """AWS policy wildcards: only ``*`` (any run) and ``?`` (any one
    char) are metacharacters — brackets etc. match literally (fnmatch
    character classes would silently change Deny semantics for keys
    containing ``[``)."""
    rx = "".join(
        ".*" if ch == "*" else "." if ch == "?" else re.escape(ch)
        for ch in pattern
    )
    return re.fullmatch(rx, value) is not None


def _match_any(patterns: list[str], value: str) -> bool:
    return any(_wild_match(p, value) for p in patterns)


def _stmt_matches(stmt: dict, principal: str, action: str,
                  resource: str) -> bool:
    prins = _principals(stmt)
    if "*" not in prins and principal not in prins:
        return False
    acts = _listify(stmt["Action"]) if "Action" in stmt else []
    nacts = _listify(stmt["NotAction"]) if "NotAction" in stmt else []
    if acts:
        if not _match_any(acts, action):
            return False
    elif _match_any(nacts, action):
        return False
    res = [_norm_resource(r) for r in _listify(stmt["Resource"])]
    return _match_any(res, resource)


def evaluate(doc: dict, principal: str, action: str,
             resource: str) -> str:
    """'deny' | 'allow' | 'default' (explicit deny wins; no match
    falls back to the caller's ACL path)."""
    verdict = "default"
    for stmt in doc.get("Statement", ()):
        if not _stmt_matches(stmt, principal, action, resource):
            continue
        if stmt["Effect"] == "Deny":
            return "deny"
        verdict = "allow"
    return verdict
