"""The port's Swift front end and file view of buckets against the JAX
package's.

The scenarios of tests/test_swift.py (the TempAuth handshake, account,
container and object verbs, metadata, S3 interop, SLO and DLO manifests,
listings, expiry, bulk delete), tests/test_swift_tempurl.py (temporary
URLs) and tests/test_rgw_file.py (the NFS-style namespace over buckets:
create, write, read, rename, readdir, statfs) run on both packages, the
port's daemons on ``device="cpu"``, each with its transcript (see
tests/test_torch_rgw.py) equal across them: every call into the gateway,
``SwiftFrontend`` and ``RGWFileSystem`` with its result or error, every
HTTP exchange of the test's own client (status, headers, body), and at
teardown every RADOS object of every pool.
"""

import pytest

from test_torch_rgw import run_twin_scenario, scenarios

SWIFT_FILE = [*scenarios("test_swift"), *scenarios("test_swift_tempurl"),
              *scenarios("test_rgw_file")]


@pytest.mark.parametrize("ref,name", SWIFT_FILE)
def test_swift_and_file_scenario_equal_across_packages(ref, name,
                                                       monkeypatch):
    run_twin_scenario(ref, name, monkeypatch)
