"""The interactive layer: scribbles (S2M), clicks (f-BRS), the free brush,
the GUI workspace, the headless SessionController and the Qt App.

Counterpart of xmem2_tpu/interactive/. gui.py and gui_utils.py import PyQt5;
nothing else here does, and nothing imports cv2 when it is imported.
"""
