'''
Shared GUI building blocks: the themed toplevel window every KvarQ window
derives from, a scrolled listbox/text factory (used by the launcher and
the explorers), a tiny background-job dialog and small dialog helpers.
'''

import os
import threading
import tkinter as tk
import tkinter.filedialog as tkfiledialog
import tkinter.font as tkfont
import webbrowser

from kvarq_tpu import VERSION
from kvarq_tpu.util import get_help_path


def resolve_extent(value, screen, minimum, maximum):
    ''' window geometry helper: a value can be absolute pixels, a fraction
        of the screen (0..1) or a negative offset from the screen edge;
        the result is clamped to ``[minimum, maximum]`` '''
    if value < 0:
        value = screen + value
    elif value < 1:
        value = int(screen * value)
    return max(minimum, min(value, maximum))


class ThemedTk(tk.Tk):

    ''' toplevel window with the KvarQ title prefix, standard fonts, and
        optional escape-to-close / geometry conveniences '''

    def __init__(self, title=None, esc_closes=False, geometry=None):
        '''
        :param esc_closes: bind ``<Escape>`` to the overridable
            :py:meth:`close` callback
        :param geometry: ``(width, height)`` -- see
            :py:func:`resolve_extent` for the accepted value forms
        '''
        tk.Tk.__init__(self)
        self.wm_title('kvarq_tpu %s%s'
                      % (VERSION, ' -- ' + title if title else ''))
        try:
            # window icon (the reference ships res/TPH_DNA.ico; ours is
            # kvarq_tpu/gui/res/icon.png, tools/make_icon.py); cosmetic,
            # so any failure -- headless test Tk fakes, exotic window
            # managers, stripped installs -- is silently ignored
            icon = os.path.join(os.path.dirname(__file__), 'res',
                                'icon.png')
            self._iconphoto_ref = tk.PhotoImage(file=icon)
            self.iconphoto(True, self._iconphoto_ref)
        except Exception:
            pass

        self.monospace = tkfont.Font(self, family='Courier New',
                                     weight=tkfont.BOLD)
        self.boldfont = tkfont.Font(self, weight='bold')

        if esc_closes:
            self.bind('<Escape>', lambda _: self.close())

        if geometry:
            sw, sh = self.winfo_screenwidth(), self.winfo_screenheight()
            w = resolve_extent(geometry[0], sw, 200, sw - 100)
            h = resolve_extent(geometry[1], sh, 200, sh - 200)
            self.geometry('%dx%d+%d+%d' % (w, h, 50, (sh - h) // 2))

        self.focus_force()

    def close(self, _=None):
        self.destroy()


def scrolled(widget_cls, parent, **kwargs):
    ''' create ``widget_cls`` (Listbox/Text) with an attached vertical
        scrollbar inside a new frame; returns ``(frame, widget)`` and
        leaves the scrollbar on ``widget.yscrollbar`` '''
    frame = tk.Frame(parent)
    widget = widget_cls(frame, **kwargs)
    widget.pack(side=tk.LEFT, fill=tk.BOTH, expand=True)
    bar = tk.Scrollbar(frame, command=widget.yview)
    bar.pack(side=tk.RIGHT, fill=tk.Y)
    widget.config(yscrollcommand=bar.set)
    widget.yscrollbar = bar
    return frame, widget


def open_help(page='index', anchor=None):
    webbrowser.open(get_help_path(page, anchor, need_url=True))


class BackgroundJob(tk.Tk):

    ''' progress dialog that runs a callable on a worker thread; the
        worker communicates through ``.message`` (shown in the label),
        ``.canceled`` (set by the cancel button) and ``.data`` '''

    POLL_MS = 100

    def __init__(self, title):
        tk.Tk.__init__(self)
        self.title(title)
        self.label = tk.Label(self)
        self.label.pack(expand=1, fill='x')
        tk.Button(self, text='cancel',
                  command=self.cancel_cb).pack()
        self.geometry('300x150')
        self.resizable(0, 0)

        self.canceled = False
        self.message = ''
        self.data = None
        self.thread = None
        self.done_cb = None

    def start(self, run, done_cb=None):
        self.thread = threading.Thread(target=run)
        self.done_cb = done_cb
        self.thread.start()
        self._poll()

    def _poll(self):
        if self.thread.is_alive():
            self.label.config(text=self.message)
            self.after(self.POLL_MS, self._poll)
        else:
            self.thread = None
            self.destroy()
            if self.done_cb:
                self.done_cb()

    # kept for API compatibility with the reference dialog
    update = _poll

    def cancel_cb(self, _=None):
        self.canceled = True


def askopenfilename(*args, **kwargs):
    ''' multi-select file dialog normalized to always return a list (some
        Tk builds return a tuple, old ones a brace-grouped string) '''
    picked = tkfiledialog.askopenfilename(*args, **kwargs)
    if not picked:
        return []
    if isinstance(picked, tuple):
        return list(picked)
    helper = tk.Tk()
    helper.withdraw()
    try:
        return list(helper.tk.splitlist(picked))
    finally:
        helper.destroy()
