"""SARIF 2.1.0 rendering for the port's lint/check findings (the port
of ``repic_tpu.analysis.sarif``).

GitHub code scanning (and most SARIF viewers) can ingest the output of
``python -m repic_tpu_torch lint --format sarif``: one run, one driver
(``repic-tpu-lint``), a rule table assembled only from the port's packs
(RT004/RT2xx per-file lint, RT101/RT102 and RT423/RT425 via
``--deep``, RT3xx via ``--concurrency``, RT401/RT402/RT404 via
``--spmd``, RT502/RT512 via ``--cost``), and one result per finding
with a physical location.  Pure stdlib: the renderer imports no torch.

The field contract (pinned by tests/test_lint_smoke.py):

* ``version`` == "2.1.0" and the matching ``$schema``
* ``runs[0].tool.driver.name`` == "repic-tpu-lint", with ``rules``
  entries carrying ``id``, ``shortDescription.text``, ``help.text``
  and ``defaultConfiguration.level``
* ``runs[0].results[*]``: ``ruleId``, ``ruleIndex``, ``level``
  (``error``/``warning``), ``message.text``, and
  ``locations[0].physicalLocation`` with ``artifactLocation.uri``
  plus a 1-based ``region.startLine``/``startColumn``
"""

from __future__ import annotations

SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def _known_rules() -> dict:
    """id -> (severity, title, hint) for every rule pack that can
    contribute findings to a lint report."""
    from repic_tpu_torch.analysis.concurrency import CONCURRENCY_RULES
    from repic_tpu_torch.analysis.cost import COST_RULES
    from repic_tpu_torch.analysis.kernels import KERNEL_RULES
    from repic_tpu_torch.analysis.rules import ALL_RULES
    from repic_tpu_torch.analysis.semantic import SEMANTIC_RULES
    from repic_tpu_torch.analysis.spmd import SPMD_RULES

    out = {
        "RT000": (
            "error",
            "analysis error (unreadable path / syntax error)",
            "",
        )
    }
    for rule in ALL_RULES:
        out[rule.rule_id] = (rule.severity, rule.title, rule.hint)
    for rule in CONCURRENCY_RULES.values():
        out[rule.rule_id] = (rule.severity, rule.title, rule.hint)
    for rule in SPMD_RULES.values():
        out[rule.rule_id] = (rule.severity, rule.title, rule.hint)
    for rule in COST_RULES.values():
        out[rule.rule_id] = (rule.severity, rule.title, rule.hint)
    for rule_id, (severity, hint) in SEMANTIC_RULES.items():
        out[rule_id] = (severity, f"trace-time contract {rule_id}",
                        hint)
    for rule_id, (severity, title, hint) in KERNEL_RULES.items():
        out[rule_id] = (severity, title, hint)
    return out


def render_sarif(findings) -> dict:
    """SARIF 2.1.0 document for a list of engine ``Finding``s."""
    from repic_tpu_torch import __version__

    known = _known_rules()
    rule_ids = sorted(
        {f.rule for f in findings} | set(known)
    )
    rules = []
    index = {}
    for i, rule_id in enumerate(rule_ids):
        severity, title, hint = known.get(
            rule_id, ("warning", rule_id, "")
        )
        index[rule_id] = i
        rules.append(
            {
                "id": rule_id,
                "shortDescription": {"text": title or rule_id},
                "help": {"text": hint or title or rule_id},
                "defaultConfiguration": {"level": severity},
            }
        )
    results = []
    for f in findings:
        results.append(
            {
                "ruleId": f.rule,
                "ruleIndex": index[f.rule],
                "level": (
                    f.severity
                    if f.severity in ("error", "warning", "note")
                    else "warning"
                ),
                "message": {"text": f.message},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": f.path.replace("\\", "/"),
                            },
                            "region": {
                                "startLine": max(int(f.line), 1),
                                "startColumn": int(f.col) + 1,
                            },
                        }
                    }
                ],
            }
        )
    return {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "repic-tpu-lint",
                        "informationUri": (
                            "https://github.com/repic-tpu/repic-tpu"
                            "/blob/main/docs/static_analysis.md"
                        ),
                        "version": __version__,
                        "rules": rules,
                    }
                },
                "results": results,
            }
        ],
    }
