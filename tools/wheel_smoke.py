#!/usr/bin/env python
'''
Clean-machine install smoke test: build the wheel, install it into a
fresh virtualenv (offline: ``--no-index --no-deps``, numpy/jax provided
by ``--system-site-packages``), and run the golden ``kvarq scan`` end to
end from a scratch directory -- proving the full packaging story (the
shipped testsuites + reconstructed genome, the prebuilt native reader,
the console entry point, the precompiled kernel cache), the way the
reference's NSIS installer was proven by use (reference setup.py:41-82,
win32/nsis/installer.nsi).

Usage: python tools/wheel_smoke.py [--keep]
Exit 0 iff the installed wheel reproduces the golden result strings of
reference tests/test_cli.py:155-172.
'''

import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

GOLDEN = [
    'lineage 3',
    'Streptomycin resistance::SNP781687AG=rpsL.K43R',
    'Rifampicin resistance (RRDR) [761139CG=rpoB.H445D 761140AG=rpoB.H445R]',
    '703777740003771',
]


def run(cmd, **kw):
    print('+ ' + ' '.join(cmd), file=sys.stderr)
    return subprocess.run(cmd, check=True, **kw)


def main():
    keep = '--keep' in sys.argv
    tmp = tempfile.mkdtemp(prefix='kvarq_wheel_smoke_')
    try:
        # 1. build the wheel (PEP 517)
        run([sys.executable, '-m', 'pip', 'wheel', '--no-deps',
             '--no-build-isolation', '-w', tmp, ROOT],
            cwd=tmp)
        wheels = [f for f in os.listdir(tmp) if f.endswith('.whl')]
        assert len(wheels) == 1, wheels
        wheel = os.path.join(tmp, wheels[0])
        print('built %s (%.1f MB)' % (
            wheels[0], os.path.getsize(wheel) / 1e6), file=sys.stderr)

        # 2. fresh venv; the wheel installs offline with the venv's own
        # pip (correct entry-point shebangs).  Dependencies (numpy/jax)
        # come from the invoking environment via a .pth bridge --
        # --system-site-packages would point at the BASE interpreter,
        # which is wrong when this tool itself runs inside a venv.
        venv = os.path.join(tmp, 'venv')
        run([sys.executable, '-m', 'venv', venv])
        vpy = os.path.join(venv, 'bin', 'python')
        run([vpy, '-m', 'pip', 'install', '--quiet', '--no-index',
             '--no-deps', wheel])
        import sysconfig
        site_dir = subprocess.run(
            [vpy, '-c', 'import sysconfig; '
             'print(sysconfig.get_paths()["purelib"])'],
            check=True, capture_output=True, text=True).stdout.strip()
        with open(os.path.join(site_dir, '_parent_deps.pth'), 'w') as f:
            f.write(sysconfig.get_paths()['purelib'] + '\n')

        # 3. golden end-to-end scan from a scratch cwd, via the console
        # entry point, with no access to the source tree
        work = os.path.join(tmp, 'work')
        os.makedirs(work)
        fastq = os.path.join(ROOT, 'tests', 'fastqs',
                             'L3_N1014_hits_5k.fastq')
        shutil.copy(fastq, work)
        kvarq = os.path.join(venv, 'bin', 'kvarq')
        env = dict(os.environ)
        env.pop('PYTHONPATH', None)
        run([kvarq, 'scan', '-f', '-l', 'MTBC',
             'L3_N1014_hits_5k.fastq', 'out.json'], cwd=work, env=env)
        out = run([kvarq, 'illustrate', '-r', 'out.json'], cwd=work,
                  env=env, capture_output=True, text=True).stdout
        missing = [g for g in GOLDEN if g not in out]
        if missing:
            print(out)
            print('MISSING golden strings: %r' % missing, file=sys.stderr)
            return 1
        # 4. the installed native reader must actually load (not the
        # numpy fallback) -- proves the wheel build compiled
        # csrc/_reader.so, shipped it, and that it runs.
        # cwd must NOT be the repo root: python -c puts the cwd on
        # sys.path, which would resolve kvarq_tpu to the source tree
        # and defeat the probe
        run([vpy, '-c',
             'from kvarq_tpu.engine import native; '
             'import sys; sys.exit(0 if native.available() else 3)'],
            cwd=work, env=env)
        print('WHEEL SMOKE OK: golden strings reproduced from the '
              'installed wheel; native reader loaded')
        return 0
    finally:
        if keep:
            print('kept %s' % tmp, file=sys.stderr)
        else:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == '__main__':
    sys.exit(main())
