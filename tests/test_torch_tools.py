"""The port's offline tools, dencoder and admin CLIs against the JAX
package's.

The scenarios of tests/test_dr_tools.py (monstore_tool's dump, get,
install and rebuild, monmaptool, osdmaptool, the rebuild of a quorum lost
whole, the objectstore tool's constants, and the MDS lookup, file-view and
push-cursor cases it also holds), tests/test_tools.py (rbd, radosgw-admin, the
objectstore tool, ``rados export``/``import``, groups and namespaces
through the rbd tool), tests/test_dencoder.py and the CLI cases of
tests/test_harness.py (over TCP, each package's twin on a port range of
its own) and tests/test_forensics.py run on both packages, the port's
daemons on ``device="cpu"``, each with its transcript (see
tests/test_torch_rgw.py) equal across them: every tool run through its
``main`` or ``_run`` with its arguments, return code and standard output,
every gateway and block-image call with its result, and at teardown every
RADOS object of every pool.  Every wire type the dencoder knows encodes to
the same bytes in both packages.

Not twinned: test_dr_tools' case of ``bench.py``'s budget guard (the JAX
package's benchmark harness, which the port has no counterpart of).
"""

import pytest

from test_torch_rgw import run_twin_scenario, scenarios

DR = [n for n in (
    "test_objectstore_tool_constants_match_daemon",
    "test_monstore_dump_get_round_trip",
    "test_monstore_install_preserves_old_store",
    "test_build_rebuild_tx_layout", "test_monmaptool_round_trip",
    "test_dr_rebuild_after_total_mon_loss",
    "test_mds_stale_fragtree_retry_finds_moved_name",
    "test_ec_mesh_applier_pin_and_lru",
    "test_rgw_file_rename_subtree_guards",
    "test_rgw_push_cursor_load_backoff")]
TOOLS = [
    *scenarios("test_dr_tools", DR),
    *scenarios("test_tools"),
    *scenarios("test_dencoder", ["test_cli", "test_detects_corruption"]),
    *scenarios("test_harness", ["test_cli_end_to_end", "test_osd_df_cli"]),
]

# Unit scenarios that call nothing the transcript records (the tools'
# helpers, the MDS's dentry lookup over a stub, a backend's applier cache,
# a push cursor's backoff): each holds its own assertions on both
# packages.
UNRECORDED = {"test_objectstore_tool_constants_match_daemon",
              "test_monstore_install_preserves_old_store",
              "test_build_rebuild_tx_layout",
              "test_mds_stale_fragtree_retry_finds_moved_name",
              "test_ec_mesh_applier_pin_and_lru",
              "test_rgw_push_cursor_load_backoff",
              "test_detects_corruption"}


@pytest.mark.parametrize("ref,name", TOOLS)
def test_tool_scenario_equal_across_packages(ref, name, monkeypatch,
                                             tmp_path, capsys):
    run_twin_scenario(ref, name, monkeypatch, compare=name not in UNRECORDED,
                      tmp_path=tmp_path, capsys=capsys)


def test_forensics_cli_reads_the_bundle_on_both_packages(monkeypatch,
                                                         tmp_path):
    """test_forensics' SLO-violation capture and its offline CLI reader
    (``forensics ls``/``show``) on both packages: which writes stalled,
    when the SLO raised and what the timeline holds follow the clock, so
    no transcript compares; the scenario's own assertions (each CLI run's
    return code 0, the bundle listed, the raise and the failpoint on the
    timeline shown) hold on each package."""
    run_twin_scenario("test_forensics",
                      "test_slo_violation_auto_captures_bundle",
                      monkeypatch, compare=False, tmp_path=tmp_path)


def _encoded(pkg, name):
    import importlib

    dencoder = importlib.import_module(f"{pkg}.dencoder")
    codec = importlib.import_module(f"{pkg}.msg.codec")
    spec = dencoder._registry()[name]
    out = []
    for inst in spec["instances"]():
        a = spec["project"](inst)
        out.append(a if isinstance(a, (bytes, bytearray))
                   else codec.encode(a))
    return out


def _names():
    from ceph_tpu import dencoder

    return sorted(dencoder._registry())


@pytest.mark.parametrize("name", _names())
def test_dencoder_type_round_trips_to_the_same_bytes(name):
    """tests/test_dencoder.py's round trip of every wire type, on both
    packages, and each sample instance's encoding byte-equal across
    them."""
    from ceph_tpu import dencoder as jax_dencoder
    from ceph_tpu_torch import dencoder as port_dencoder

    assert sorted(port_dencoder._registry()) == _names()
    assert jax_dencoder.check(name) == port_dencoder.check(name) == []
    ref = _encoded("ceph_tpu", name)
    assert ref and _encoded("ceph_tpu_torch", name) == ref
